"""The hub: reference checkpoints opened in the port, and weight conversion from the JAX
package."""

from .from_jax import (
    adanet_state_dict_from_jax, conv_tasnet_state_dict_from_jax, d3net_state_dict_from_jax,
    danet_state_dict_from_jax, densenet_state_dict_from_jax, m_densenet_state_dict_from_jax,
    mm_dense_rnn_state_dict_from_jax, mm_densenet_state_dict_from_jax, parallel_state_dict_from_jax,
    deep_embedding_state_dict_from_jax, dprnn_tasnet_state_dict_from_jax,
    dptnet_state_dict_from_jax, furcanet_state_dict_from_jax, galrnet_state_dict_from_jax,
    cunet_state_dict_from_jax, hrnet_state_dict_from_jax, lstm_tasnet_state_dict_from_jax,
    unet_state_dict_from_jax, meta_tasnet_state_dict_from_jax, mrx_state_dict_from_jax,
    open_unmix_state_dict_from_jax, parallel_open_unmix_state_dict_from_jax,
    sepformer_state_dict_from_jax, tree_state_dict_from_jax, wavenet_state_dict_from_jax,
    wavesplit_state_dict_from_jax,
    xumx_state_dict_from_jax,
)
from .pretrained import build_from_pretrained
from .torch_checkpoint import build_from_torch_checkpoint

__all__ = ["build_from_pretrained", "build_from_torch_checkpoint",
           "adanet_state_dict_from_jax", "conv_tasnet_state_dict_from_jax",
           "d3net_state_dict_from_jax", "m_densenet_state_dict_from_jax",
           "mm_dense_rnn_state_dict_from_jax", "mm_densenet_state_dict_from_jax",
           "parallel_state_dict_from_jax",
           "danet_state_dict_from_jax", "densenet_state_dict_from_jax",
           "deep_embedding_state_dict_from_jax",
           "dprnn_tasnet_state_dict_from_jax", "dptnet_state_dict_from_jax",
           "furcanet_state_dict_from_jax", "galrnet_state_dict_from_jax",
           "cunet_state_dict_from_jax", "hrnet_state_dict_from_jax",
           "unet_state_dict_from_jax", "lstm_tasnet_state_dict_from_jax", "meta_tasnet_state_dict_from_jax",
           "mrx_state_dict_from_jax", "open_unmix_state_dict_from_jax",
           "parallel_open_unmix_state_dict_from_jax", "sepformer_state_dict_from_jax",
           "tree_state_dict_from_jax",
           "wavenet_state_dict_from_jax", "wavesplit_state_dict_from_jax",
           "xumx_state_dict_from_jax"]
