from .generate import (GenerationConfig, generate_with_kv_cache,
                       sample_for_reinforce, sequence_mask)
from .latent import (centroid_walk, element_anchored_blend, element_jaccard_neighbors,
                     interpolation_sweep, lerp, pca_components, pca_walk, perturb, slerp)
