from .compositional_targets import (compositional_targets,
                                    normalized_compositional_targets)
from .pipeline import (SC_CATEGORY_LABELS, category_to_label, composition_slots,
                       parse_formula_composition, read_csv_rows)
