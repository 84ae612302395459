"""Weight conversion between the JAX package and the port."""

from .from_jax import (
    conv_tasnet_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax, dptnet_state_dict_from_jax,
    furcanet_state_dict_from_jax, galrnet_state_dict_from_jax, lstm_tasnet_state_dict_from_jax,
    meta_tasnet_state_dict_from_jax, mrx_state_dict_from_jax, open_unmix_state_dict_from_jax,
    parallel_open_unmix_state_dict_from_jax, sepformer_state_dict_from_jax,
    wavenet_state_dict_from_jax, xumx_state_dict_from_jax,
)

__all__ = ["conv_tasnet_state_dict_from_jax", "dprnn_tasnet_state_dict_from_jax",
           "dptnet_state_dict_from_jax", "furcanet_state_dict_from_jax",
           "galrnet_state_dict_from_jax", "lstm_tasnet_state_dict_from_jax",
           "meta_tasnet_state_dict_from_jax", "mrx_state_dict_from_jax",
           "open_unmix_state_dict_from_jax", "parallel_open_unmix_state_dict_from_jax",
           "sepformer_state_dict_from_jax", "wavenet_state_dict_from_jax",
           "xumx_state_dict_from_jax"]
