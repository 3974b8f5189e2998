from .config import ModelConfig, config_from_meta, tiny_test_config
from .decoder import FormulaDecoder
from .encoder import MaterialsEncoder
from .init import init_params
from .set_decoder import SetDecoderLayer, SetFormulaDecoder
