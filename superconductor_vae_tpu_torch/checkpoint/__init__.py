from .from_jax import params_from_jax
