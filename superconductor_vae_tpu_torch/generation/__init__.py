from .generate import (GenerationConfig, generate_with_kv_cache,
                       sample_for_reinforce, sequence_mask)
