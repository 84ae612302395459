"""Weight conversion between the JAX package and the port."""

from .from_jax import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
    open_unmix_state_dict_from_jax, parallel_open_unmix_state_dict_from_jax,
    xumx_state_dict_from_jax,
)

__all__ = ["conv_tasnet_state_dict_from_jax", "dprnn_tasnet_state_dict_from_jax",
           "open_unmix_state_dict_from_jax", "parallel_open_unmix_state_dict_from_jax",
           "xumx_state_dict_from_jax"]
