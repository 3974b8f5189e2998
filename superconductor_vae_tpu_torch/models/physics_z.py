"""Physics-supervised coordinate map for the 2048-dim latent (port of
models/physics_z.py).

Names blocks of z[0:512]; z[512:2048] is free discovery space.  The
physics-Z loss supervises Block 8 against the compositional targets
(data/compositional_targets.py) and Block 11 against a projection of the
Magpie features.
"""

from __future__ import annotations

from typing import Dict, Tuple

BLOCKS: Dict[str, Tuple[int, int]] = {
    'gl': (0, 20),
    'bcs': (20, 50),
    'eliashberg': (50, 70),
    'unconventional': (70, 110),
    'structural': (110, 160),
    'electronic': (160, 210),
    'thermodynamic': (210, 270),
    'compositional': (270, 340),
    'cobordism': (340, 400),
    'ratios': (400, 450),
    'magpie': (450, 512),
    'discovery': (512, 2048),
}

# named scalar coordinates used by the losses
KAPPA, XI, LAMBDA_L, DELTA0, HC, HC1, HC2 = 0, 1, 2, 3, 4, 5, 6
ALPHA_GL, BETA_GL, E_COND, SIGMA_NS = 7, 8, 9, 10
V_F = 20
THETA_D, GAP_RATIO = 27, 29
L_MFP = 35
LATTICE_A, LATTICE_B, LATTICE_C, VOLUME = 113, 114, 115, 119
PLASMA_FREQ, DRUDE_WEIGHT = 164, 165
TC = 210
TC_ONSET, TC_MIDPOINT, TC_ZERO = 211, 212, 213
DELTA_TC = 214
E_VORTEX, E_DOMAIN, E_DEFECT_MIN, TYPE_I_II = 340, 341, 343, 344
TC_THETA_D, XI_L = 400, 403

# Block 8 compositional coordinates, in the order of
# data/compositional_targets.py COMP_TARGET_NAMES
COMP_COORDS = (
    270,  # n_elements
    271,  # mw
    272,  # x_h
    273,  # z_avg
    274,  # z_max
    275,  # en_avg
    276,  # en_diff
    277,  # r_avg
    278,  # r_ratio
    279,  # vec
    287,  # d_orbital_frac
    288,  # f_orbital_frac
    289,  # ie_avg
    285,  # tm_avg (reserved coord reused, as in the reference)
    281,  # delta_size
)

N_SUPERVISED = 512
N_TOTAL = 2048


def block(name: str) -> Tuple[int, int]:
    return BLOCKS[name]


def supervised_blocks() -> Dict[str, Tuple[int, int]]:
    return {k: v for k, v in BLOCKS.items() if k != 'discovery'}
