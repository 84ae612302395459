"""Port's fused_mask_decode and ConvDecoder against the JAX package (CPU).

On CPU tensors the port's wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode (tile_t=32). The CUDA kernel
itself is checked against the plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.ops import mask_decode as md
from dnn_based_source_separation_torch.ops.filterbank import ConvDecoder
from dnn_based_source_separation_tpu.ops import filterbank as jfb
from dnn_based_source_separation_tpu.ops.pallas_kernels import fused_mask_decode as jax_fmd

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, B=2, S=2, Tp=70, N=32, CL=16):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((B, Tp, N)).astype(np.float32)
    mask = rng.uniform(0, 1, (B, S, Tp, N)).astype(np.float32)
    kernel = rng.standard_normal((N, CL)).astype(np.float32)
    return w, mask, kernel


@pytest.mark.parametrize("CL", [16, 32])
def test_fused_mask_decode_matches_pallas_interpret(CL):
    w, mask, kernel = _inputs(CL, CL=CL)  # T'=70: ragged against tile_t=32
    expected = np.asarray(jax_fmd(jnp.asarray(w), jnp.asarray(mask), jnp.asarray(kernel),
                                  tile_t=32))
    md.LAUNCHES = 0
    got = md.fused_mask_decode(torch.from_numpy(w), torch.from_numpy(mask),
                               torch.from_numpy(kernel))
    assert got.dtype == torch.float32 and got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)
    assert md.LAUNCHES == 0  # CPU tensors never reach the CUDA kernel


def test_fused_mask_decode_takes_a_strided_mask():
    # The separator hands over a (B, S, T', N) view of a (B, T', S, N) tensor.
    w, mask, kernel = _inputs(3)
    strided = torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 2, 1, 3))).transpose(1, 2)
    got = md.fused_mask_decode(torch.from_numpy(w), strided, torch.from_numpy(kernel))
    ref = md.fused_mask_decode(torch.from_numpy(w), torch.from_numpy(mask),
                               torch.from_numpy(kernel))
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_reference_rounds_the_product_in_bfloat16():
    w, mask, kernel = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4))
    got = md.fused_mask_decode_reference(w, mask, kernel)
    product = (w[:, None].float() * mask.float()).to(torch.bfloat16).float()
    expected = product @ kernel.float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, expected, rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    "dtype", "shape", "N_not_vector_multiple", "CL_too_wide", "last_dim_strided",
])
def test_cuda_argument_checks_raise(bad):
    # `_check` guards the CUDA launch; it is pure shape/dtype logic, so it
    # can be exercised on CPU tensors.
    w, mask, kernel = (torch.from_numpy(a) for a in _inputs(5))
    if bad == "dtype":
        w = w.to(torch.bfloat16)
    elif bad == "shape":
        mask = mask[:, :, :-1]
    elif bad == "N_not_vector_multiple":
        w, mask, kernel = w[..., :30], mask[..., :30], kernel[:30]
    elif bad == "CL_too_wide":
        kernel = torch.zeros(32, md.MAX_CL + 1)
    elif bad == "last_dim_strided":
        mask = torch.from_numpy(np.repeat(mask.numpy(), 2, axis=-1))[..., ::2]
    with pytest.raises((ValueError, TypeError)):
        md._check(w, mask, kernel)


def test_cuda_argument_checks_accept_the_serving_layout():
    w, mask, kernel = (torch.from_numpy(a) for a in _inputs(6))
    md._check(w, mask, kernel)
    md._check(w.to(torch.bfloat16), mask.to(torch.bfloat16), kernel.to(torch.bfloat16))


def test_unsupported_device_raises():
    w, mask, kernel = (torch.empty(a.shape, device="meta") for a in _inputs(7))
    with pytest.raises(ValueError):
        md.fused_mask_decode(w, mask, kernel)


@pytest.mark.parametrize("channels,L,stride", [(1, 8, 4), (2, 16, 8), (1, 6, 4)])
def test_conv_decoder_matches_jax_on_masked_latent(channels, L, stride):
    N = 16
    rng = np.random.default_rng(10 + L)
    w, mask, _ = _inputs(10 + L, N=N, CL=channels * L)
    jk = rng.standard_normal((N, channels * L)).astype(np.float32)
    dec = jfb.ConvDecoder(N, L, stride, out_channels=channels)
    w_hat = jnp.asarray(w)[:, None] * jnp.asarray(mask)
    expected = np.asarray(dec.apply({"params": {"kernel": jnp.asarray(jk)}}, w_hat))

    port = ConvDecoder(N, L, stride, out_channels=channels)
    port.load_state_dict({"conv_transpose1d.weight": torch.from_numpy(jk.reshape(N, channels, L))})
    md.LAUNCHES = 0
    with torch.no_grad():
        got = port(torch.from_numpy(w), torch.from_numpy(mask))
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), expected, rtol=0, atol=ATOL)
    assert md.LAUNCHES == 0
