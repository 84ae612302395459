"""Analysis-synthesis filterbanks (TasNet encoder/decoder): learned, gated and Fourier.

Port of `dnn_based_source_separation_tpu/ops/filterbank.py`. A stride-S
kernel-L Conv1d over the input channels is "frame into (B, T', C*L), then
matmul C*L -> N"; a decoder is the synthesis matmul followed by
overlap-add. Latents are channels-last (B, T', N); a Fourier encoder's are
complex (B, T', F) unless it returns [real bins, imaginary bins].

Parameter names and shapes follow the reference torch layout that
`hub/torch_convert.py:convert_conv_tasnet` reads: `conv1d.weight` (N, C, L)
for the encoder and `conv_transpose1d.weight` (N, C, L) for the decoder;
the gated encoder's `conv1d_U.weight` / `conv1d_V.weight` (N, C, L); the
Fourier filterbanks' `frequency`, `window` / `optimal_window` and `phase`
vectors as the JAX package names them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .mask_decode import fused_mask_decode, fused_mask_decode_reference
from .params import Weight, constant_parameter
from .stft import _fold, _frame
from .windows import build_optimal_window, build_window

EPS = 1e-12


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., T', frame_length), T' = (T - L)//hop + 1."""
    return _frame(x, frame_length, hop)


def unfold_apply(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Inverse of frame_signal by summation: (..., T', L) -> (..., T)."""
    *lead, S, L = frames.shape
    return _fold(frames, hop, (S - 1) * hop + L)


class ConvEncoder(nn.Module):
    """Trainable analysis filterbank. (B, T, C_in) -> latent (B, T', n_basis)."""

    def __init__(self, n_basis: int, kernel_size: int, stride: int, in_channels: int = 1,
                 nonlinear: Optional[str] = None, *, generator=None, device=None):
        super().__init__()
        if nonlinear not in (None, "relu"):
            raise ValueError(f"Unsupported encoder nonlinearity: {nonlinear}")
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.in_channels, self.nonlinear = in_channels, nonlinear
        self.conv1d = Weight((n_basis, in_channels, kernel_size), in_channels * kernel_size,
                             generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, C = x.shape
        frames = frame_signal(x.transpose(1, 2), self.kernel_size, self.stride)  # (B, C, T', L)
        frames = frames.transpose(1, 2).reshape(B, -1, C * self.kernel_size)
        y = F.linear(frames, self.conv1d.weight.reshape(self.n_basis, -1))
        if self.nonlinear == "relu":
            y = F.relu(y)
        return y

    def pinv_decode(self, w_hat: torch.Tensor) -> torch.Tensor:
        """Least-squares synthesis through the pinv of the analysis basis (monaural).

        w_hat (..., T', N) -> (..., T, 1). JAX's `jnp.linalg.pinv` cut-off is
        passed explicitly: singular values below 10 * max(N, L) * eps times
        the largest are dropped (torch's default is max(N, L) * eps). The
        pinv is taken in f32, which torch's SVD needs.
        """
        if self.nonlinear is not None:
            raise ValueError("pinv of 'Conv1d + nonlinear' is unsupported")
        duplicate = self.kernel_size // self.stride
        analysis = self.conv1d.weight.reshape(self.n_basis, -1).float()  # (N, L)
        rtol = 10.0 * max(analysis.shape) * torch.finfo(torch.float32).eps
        pinv = torch.linalg.pinv(analysis, rtol=rtol) / duplicate  # (L, N)
        frames = torch.matmul(w_hat, pinv.T.to(w_hat.dtype))  # (..., T', L)
        return unfold_apply(frames, self.stride)[..., None]


class ConvDecoder(nn.Module):
    """Trainable synthesis filterbank (transposed conv).

    forward(w, mask): latent w (B, T', N) and masks (B, S, T', N) ->
    signals (B, S, T, out_channels) float32. The masking and the synthesis
    matmul run as one fused kernel (ops/mask_decode.py), then overlap-add.
    Under autograd (training) the same function runs as plain differentiable
    ops, `fused_mask_decode_reference`, as the JAX decoder computes it: the
    kernel has no backward.
    """

    def __init__(self, n_basis: int, kernel_size: int, stride: int, out_channels: int = 1,
                 *, generator=None, device=None):
        super().__init__()
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.out_channels = out_channels
        self.conv_transpose1d = Weight((n_basis, out_channels, kernel_size),
                                       out_channels * kernel_size, generator, device)

    def forward(self, w: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        kernel = self.conv_transpose1d.weight.reshape(self.n_basis, -1)  # (N, C*L)
        recording = torch.is_grad_enabled() and any(
            t.requires_grad for t in (w, mask, kernel))
        if recording:
            frames = fused_mask_decode_reference(w, mask, kernel)  # (B, S, T', C*L)
        else:  # the kernel reads rows with a contiguous last dimension, any other stride
            w, mask = (t if t.stride(-1) == 1 else t.contiguous() for t in (w, mask))
            frames = fused_mask_decode(w, mask, kernel)
        *lead, S, _ = frames.shape
        frames = frames.reshape(*lead, S, self.out_channels, self.kernel_size)
        frames = frames.movedim(-2, -3)  # (B, S, C, T', L)
        y = unfold_apply(frames, self.stride)  # (B, S, C, T)
        return y.movedim(-2, -1)  # (B, S, T, C)


def _omega0(n_basis: int, device) -> torch.Tensor:
    """The DFT bin frequencies 2 pi k / n_basis, k = 0 .. n_basis // 2."""
    k = torch.arange(n_basis // 2 + 1, dtype=torch.float64, device=device)
    return (2.0 * math.pi * k / n_basis).float()


def _mirror_rows(real: torch.Tensor, imag: torch.Tensor):
    """Append the interior bins flipped, the imaginary ones negated (conjugate symmetry)."""
    return (torch.cat([real, real[1:-1].flip(0)], dim=0),
            torch.cat([imag, -imag[1:-1].flip(0)], dim=0))


class _Fourier(nn.Module):
    """The frequency and phase parameters shared by the Fourier encoder and decoder."""

    def __init__(self, n_basis: int, kernel_size: int, stride: int, trainable: bool,
                 trainable_phase: bool, onesided: bool, device):
        super().__init__()
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.trainable, self.trainable_phase, self.onesided = trainable, trainable_phase, onesided
        self.frequency = nn.Parameter(_omega0(n_basis, device)) if trainable else None
        self.phase = (constant_parameter((n_basis // 2 + 1,), 0.0, device)
                      if trainable_phase else None)

    def _omega_n(self, device) -> torch.Tensor:
        """(n_basis // 2 + 1, L): frequency x sample index, plus the phase."""
        frequency = self.frequency if self.trainable else _omega0(self.n_basis, device)
        n = torch.arange(self.kernel_size, dtype=torch.float32, device=device)
        omega_n = frequency[:, None] * n[None, :].to(frequency.dtype)
        if self.phase is not None:
            omega_n = omega_n + self.phase[:, None]
        return omega_n


class FourierEncoder(_Fourier):
    """Fixed or trainable Fourier analysis filterbank (monaural).

    (B, T, 1) -> (B, T', F) complex if `return_complex`, else (B, T', 2F)
    laid out as [real bins, imaginary bins]. Rows are window x cos(-omega n
    - phi) and window x sin(-omega n - phi); two-sided adds the interior
    bins mirrored. `window` is a parameter, as in the JAX package.
    """

    def __init__(self, n_basis: int, kernel_size: int, stride: int, window_fn: str = "hann",
                 trainable: bool = False, trainable_phase: bool = False, onesided: bool = True,
                 return_complex: bool = True, *, device=None):
        super().__init__(n_basis, kernel_size, stride, trainable, trainable_phase, onesided,
                         device)
        self.return_complex = return_complex
        self.window = nn.Parameter(build_window(kernel_size, window_fn, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-1] != 1:
            raise ValueError("Fourier filterbanks are monaural")
        omega_n = self._omega_n(x.device)
        real, imag = torch.cos(-omega_n), torch.sin(-omega_n)
        if not self.onesided:
            real, imag = _mirror_rows(real, imag)
        real, imag = self.window * real, self.window * imag
        frames = frame_signal(x[..., 0], self.kernel_size, self.stride)  # (B, T', L)
        out_r = torch.matmul(frames, real.T.to(frames.dtype))
        out_i = torch.matmul(frames, imag.T.to(frames.dtype))
        if self.return_complex:
            return torch.complex(out_r.float(), out_i.float())
        return torch.cat([out_r, out_i], dim=-1)


class FourierDecoder(_Fourier):
    """Fourier synthesis filterbank with the optimal synthesis window.

    forward(w_hat): masked latent (..., T', F) complex, or [real, imaginary]
    bins, -> (..., T, 1). The synthesis rows are cos(omega n + phi) and
    sin(omega n + phi), mirrored to all n_basis bins, times `optimal_window`
    (a parameter, as in the JAX package) over n_basis; a one-sided latent
    is mirrored to n_basis bins first.
    """

    def __init__(self, n_basis: int, kernel_size: int, stride: int, window_fn: str = "hann",
                 trainable: bool = False, trainable_phase: bool = False, onesided: bool = True,
                 *, device=None):
        super().__init__(n_basis, kernel_size, stride, trainable, trainable_phase, onesided,
                         device)
        window = build_window(kernel_size, window_fn, device=device)
        self.optimal_window = nn.Parameter(build_optimal_window(window, stride))

    def forward(self, w_hat: torch.Tensor) -> torch.Tensor:
        omega_n = self._omega_n(w_hat.device)
        real, imag = _mirror_rows(torch.cos(omega_n), torch.sin(omega_n))
        real = self.optimal_window * real / self.n_basis
        imag = self.optimal_window * imag / self.n_basis
        if w_hat.is_complex():
            wr, wi = w_hat.real, w_hat.imag
        else:
            half = w_hat.shape[-1] // 2
            wr, wi = w_hat[..., :half], w_hat[..., half:]
        if self.onesided:
            wr = torch.cat([wr, wr[..., 1:-1].flip(-1)], dim=-1)
            wi = torch.cat([wi, -wi[..., 1:-1].flip(-1)], dim=-1)
        frames = (torch.matmul(wr, real.to(wr.dtype))
                  - torch.matmul(wi, imag.to(wi.dtype)))  # (..., T', L)
        return unfold_apply(frames, self.stride)[..., None]


class GatedEncoder(nn.Module):
    """Gated filterbank of the original TasNet: relu(U x) * sigmoid(V x).

    Each utterance is L2-normalised over time first (per channel), so the
    encoder is not frame-local and cannot be streamed.
    """

    def __init__(self, n_basis: int, kernel_size: int, stride: int, in_channels: int = 1,
                 eps: float = EPS, *, generator=None, device=None):
        super().__init__()
        self.n_basis, self.kernel_size, self.stride = n_basis, kernel_size, stride
        self.in_channels, self.eps = in_channels, eps
        shape, fan_in = (n_basis, in_channels, kernel_size), in_channels * kernel_size
        self.conv1d_U = Weight(shape, fan_in, generator, device)
        self.conv1d_V = Weight(shape, fan_in, generator, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x / (torch.linalg.vector_norm(x, dim=-2, keepdim=True) + self.eps)
        B, T, C = x.shape
        frames = frame_signal(x.transpose(1, 2), self.kernel_size, self.stride)
        frames = frames.transpose(1, 2).reshape(B, -1, C * self.kernel_size)
        u = F.linear(frames, self.conv1d_U.weight.reshape(self.n_basis, -1))
        v = F.linear(frames, self.conv1d_V.weight.reshape(self.n_basis, -1))
        return F.relu(u) * torch.sigmoid(v)


def compute_valid_basis(hidden_channels: int, onesided: bool = True,
                        return_complex: bool = True) -> int:
    """The DFT size whose Fourier latent has `hidden_channels` channels."""
    if onesided:
        if return_complex:
            if hidden_channels % 2 != 1:
                raise ValueError("`hidden_channels` is expected odd.")
            return 2 * (hidden_channels - 1)
        if hidden_channels % 2 != 0:
            raise ValueError("`hidden_channels` is expected even.")
        return 2 * (hidden_channels // 2 - 1)
    if return_complex:
        return hidden_channels
    if hidden_channels % 2 != 0:
        raise ValueError("`hidden_channels` is expected even.")
    return hidden_channels // 2


FOURIER = ("Fourier", "trainableFourier", "trainableFourierTrainablePhase")


def choose_filterbank(hidden_channels: int, kernel_size: int, stride: int | None = None,
                      enc_basis: str = "trainable", dec_basis: str = "trainable",
                      *, generator=None, device=None, **kwargs):
    """(encoder, decoder) for the basis names; the decoder is None for 'pinv'.

    encoders: 'trainable', 'trainableGated' and the Fourier ones; decoders:
    'trainable', the Fourier ones and 'pinv' (the trainable encoder's
    `pinv_decode`, its nonlinearity dropped).
    """
    in_channels = kwargs.get("in_channels") or 1
    stride = stride or kernel_size // 2
    onesided = bool(kwargs.get("enc_onesided", True))
    return_complex = bool(kwargs.get("enc_return_complex", True))
    window_fn = kwargs.get("window_fn", "hann")
    if (enc_basis in FOURIER or dec_basis in FOURIER or dec_basis == "pinv") and in_channels != 1:
        raise ValueError(f"{enc_basis!r}/{dec_basis!r} filterbanks are monaural")

    if enc_basis == "trainable":
        nonlinear = None if dec_basis == "pinv" else kwargs.get("enc_nonlinear")
        encoder = ConvEncoder(hidden_channels, kernel_size, stride, in_channels=in_channels,
                              nonlinear=nonlinear, generator=generator, device=device)
    elif enc_basis in FOURIER:
        encoder = FourierEncoder(
            compute_valid_basis(hidden_channels, onesided, return_complex), kernel_size, stride,
            window_fn=window_fn, trainable=enc_basis != "Fourier",
            trainable_phase=enc_basis == "trainableFourierTrainablePhase", onesided=onesided,
            return_complex=return_complex, device=device)
    elif enc_basis == "trainableGated":
        encoder = GatedEncoder(hidden_channels, kernel_size, stride, in_channels=in_channels,
                               generator=generator, device=device)
    else:
        raise NotImplementedError(f"Unsupported encoder basis: {enc_basis}")

    if dec_basis == "trainable":
        decoder = ConvDecoder(hidden_channels, kernel_size, stride, out_channels=in_channels,
                              generator=generator, device=device)
    elif dec_basis in FOURIER:
        decoder = FourierDecoder(
            compute_valid_basis(hidden_channels, onesided, return_complex), kernel_size, stride,
            window_fn=window_fn, trainable=dec_basis != "Fourier",
            trainable_phase=dec_basis == "trainableFourierTrainablePhase", onesided=onesided,
            device=device)
    elif dec_basis == "pinv":
        if enc_basis != "trainable":
            raise NotImplementedError("the pinv decoder inverts the trainable encoder only")
        decoder = None  # synthesis rides encoder.pinv_decode (the shared kernel)
    else:
        raise NotImplementedError(f"Unsupported decoder basis: {dec_basis}")
    return encoder, decoder
