from .compositional_targets import (compositional_targets,
                                    normalized_compositional_targets)
from .pipeline import (SC_CATEGORY_LABELS, DatasetArrays, NormStats,
                       canonical_composition_key, category_to_label,
                       composition_slots, compute_sample_weights, load_dataset,
                       load_holdout_formulas, parse_formula_composition,
                       read_csv_rows, resample_order_augmentation)
from .sampler import WeightedEpochSampler, shard_batch_indices
from .synthetic import synthetic_dataset
