from .formula_corrector import FormulaCorrector, CorrectionResult
from .fraction_corrector import COMMON_DENOMINATORS, FractionCorrector
