from .compositional_targets import (compositional_targets,
                                    normalized_compositional_targets)
from .pipeline import (SC_CATEGORY_LABELS, DatasetArrays, NormStats,
                       canonical_composition_key, category_to_label,
                       composition_slots, load_dataset, load_holdout_formulas,
                       parse_formula_composition, read_csv_rows)
from .synthetic import synthetic_dataset
