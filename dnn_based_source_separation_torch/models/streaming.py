"""Streaming inference: exact, hop by hop, for causal Conv-TasNet, the
stream-safe causal DPRNN-TasNet and causal LSTM-TasNet with the trainable
encoder; and the windowed approximation.

Port of `dnn_based_source_separation_tpu/models/streaming.py`.
`ExactStreamingSeparator`, fed a stream hop by hop, emits what the offline
forward of the whole stream gives, to float rounding, by carrying state
instead of recomputing a window:

- encoder framing: the unframed input samples (fewer than one latent hop's
  worth) wait for the next call;
- the separator (`Separator.stream` of each model): the cLNs' running
  statistics; for Conv-TasNet each residual block's last
  (kernel_size - 1) * dilation post-norm frames; for DPRNN-TasNet the
  inter-chunk RNN state, the last K - P bottleneck frames and the K - P
  frames of partial overlap-add sums; for LSTM-TasNet each stacked
  unidirectional LSTM's (h, c) per layer (its norm, skip sums, `fc` and mask
  are frame-local);
- a latent delay line of D frames (DPRNN-TasNet: D = K - P; an emitted mask
  frame's chunk is complete only D frames after its latent frame, so the
  latent is delayed to meet its mask, and the first D * S output samples,
  the image of the offline left pad, are trimmed). Conv-TasNet and
  LSTM-TasNet have D = 0 and a latent hop of P = 1 frame;
- the decoder's overlap-add tail of L - S samples.

The state is plain tensors on the model's device, passed explicitly from
call to call; the separator's carried state stays f32 whatever the model
dtype. Each separator call decodes once (`fused_mask_decode` for the
trainable decoder). For DPRNN-TasNet the intra-chunk BiRNN of each block
launches its fused bidirectional kernel once per call that runs the
dual-path stack; the carried inter-chunk recurrence, like LSTM-TasNet's
LSTMs, is a plain step loop (`ops/rnn.py:stream`).

`StreamingSeparator` runs the offline forward over a rolling window of
context + hop samples and keeps the last hop. Its convolutions see their
whole receptive field, but cLN accumulates its statistics from the window
start, not the stream start, so it only approximates the offline output
(about 23 dB for a random-weight causal Conv-TasNet, JAX's measurement).

Usage:
    stream = ExactStreamingSeparator(model, hop_samples=400)
    for block in blocks:               # (hop,) or (1, hop) float32
        est = stream.process(block)    # (n_sources, emitted) float32
    est = stream.finish(rest)          # everything that remains
"""
from __future__ import annotations

import torch


class StreamingSeparator:
    """Windowed chunk-by-chunk separation for causal models (approximate: see above)."""

    def __init__(self, model, hop_samples: int, context_samples: int, n_channels: int = 1):
        self.model, self.hop, self.context = model, int(hop_samples), int(context_samples)
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self._buf = torch.zeros((n_channels, self.context), device=self.device)

    @torch.inference_mode()
    def process(self, block) -> torch.Tensor:
        """block (C, hop) or (hop,) new samples -> (n_sources, [C,] hop) float32 on the device."""
        block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        block = block[None] if block.dim() == 1 else block
        if block.shape[-1] != self.hop:
            raise ValueError(f"streaming blocks must be exactly hop={self.hop} samples, got "
                             f"{block.shape[-1]}; pad the final partial block or use flush()")
        x = torch.cat([self._buf, block], dim=-1)  # (C, context + hop)
        est = self.model(x[None].to(self.dtype))[0][..., -self.hop:]
        self._buf = x[:, x.shape[-1] - self.context:]
        return est

    def flush(self) -> torch.Tensor:
        """Process a trailing zero block (drains the final hop of context)."""
        return self.process(torch.zeros((self._buf.shape[0], self.hop)))

    def reset(self) -> None:
        self._buf = torch.zeros_like(self._buf)


class ExactStreamingSeparator:
    """Stateful hop-by-hop separation that matches the offline forward exactly."""

    def __init__(self, model, hop_samples: int):
        if not getattr(model, "causal", False):
            raise ValueError("exact streaming requires a causal model")
        if getattr(model, "dec_basis", "trainable") == "pinv":
            raise NotImplementedError("pinv decoding is not streamed")
        if getattr(model, "enc_basis", "trainable") != "trainable":
            # trainableGated L2-normalises over the whole utterance (not
            # frame-local); the Fourier encoders take the complex path.
            raise NotImplementedError(
                "exact streaming supports enc_basis='trainable' (frame-local) encoders only")
        L, S = int(model.kernel_size), int(model.stride or model.kernel_size // 2)
        if hop_samples % S or hop_samples < L:
            raise ValueError(f"hop_samples must be a multiple of stride={S} and >= "
                             f"kernel_size={L}")
        if getattr(model, "rnn_type", "lstm") not in ("lstm", "gru"):
            # JAX's RNN and SRU accept the stream collection and ignore it: a chunked JAX run
            # restarts their recurrence each call, which is not the offline output.
            raise NotImplementedError(
                "exact streaming carries RNN state for rnn_type 'lstm'/'gru' only: the JAX "
                f"package's {model.rnn_type!r} ignores the carried state (its chunked output "
                "restarts the recurrence at every call)")
        D, P = 0, 1  # Conv-TasNet: no latent delay, any number of frames a call
        if hasattr(model, "sep_chunk_size"):
            if not hasattr(model, "rnn_type"):
                # Attention-based dual-path separators (DPTNet, SepFormer, GALRNet): the
                # reference's causal mode puts no causal mask on the inter-chunk attention, so every
                # emitted frame depends on the whole stream (JAX
                # tests/test_streaming_dptnet.py); a masked variant would need a
                # key-value cache as long as the stream, not a carried state.
                raise NotImplementedError(
                    "exact streaming is not defined for attention-based dual-path "
                    "separators: the reference-parity causal DPTNet attends over future "
                    "chunks (no causal mask in the inter-chunk attention), and a masked "
                    "variant would need an unbounded KV cache; use causal DPRNN-TasNet "
                    "(stream_safe=True) for exact streaming")
            if not getattr(model, "stream_safe", False):
                raise NotImplementedError(
                    "exact streaming of a dual-path model requires stream_safe=True: the "
                    "reference-parity causal mode reads future chunks through its norms")
            K, P = int(model.sep_chunk_size), int(model.sep_hop_size)
            D = K - P
            if (hop_samples - L) // S + 1 < P:
                raise ValueError(f"hop_samples={hop_samples} yields fewer than hop_size={P} "
                                 f"latent frames per call; raise it to at least "
                                 f"{(P - 1) * S + L}")
        self.model, self.hop = model, int(hop_samples)
        self.L, self.S, self.P, self.D = L, S, P, D
        self.reset()

    def reset(self) -> None:
        """Restart the stream: every carried state back to its zero start."""
        param = next(self.model.parameters())
        self.device, self.dtype = param.device, param.dtype
        n_src, N = int(self.model.n_sources), int(self.model.n_basis)
        self._pending = torch.zeros((1, 0), device=self.device)  # unframed input samples
        self._state = {}  # the separator's carried state
        self._w_delay = torch.zeros((1, self.D, N), dtype=self.dtype, device=self.device)
        self._tail = torch.zeros((n_src, self.L - self.S), device=self.device)
        self._skip = self.D * self.S  # head samples to trim: the offline left pad's image

    def _samples(self, block) -> torch.Tensor:
        block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        return block[None] if block.dim() == 1 else block

    def _encode(self, x: torch.Tensor) -> torch.Tensor:
        """(1, T) samples on the stride grid -> latent frames (1, T', N)."""
        return self.model.encoder(x.to(self.dtype)[:, :, None])

    def _separate(self, w: torch.Tensor) -> torch.Tensor:
        """One separator call on latent frames w; decode what it emits, with the delay line."""
        mask, self._state = self.model.separator.stream(w, self._state)
        w_avail = torch.cat([self._w_delay, w], dim=1)
        m_f = mask.shape[2]
        self._w_delay = w_avail[:, m_f:]
        x_hat = self.model.decode(w_avail[:, :m_f], mask)[0, ..., 0]  # (n_src, (m_f-1)*S + L)
        n_out = x_hat.shape[-1] - (self.L - self.S)
        head = x_hat[:, :self.L - self.S] + self._tail
        emitted = torch.cat([head, x_hat[:, self.L - self.S:n_out]], dim=-1)
        self._tail = x_hat[:, n_out:]
        if self._skip:
            cut = min(self._skip, emitted.shape[-1])
            emitted, self._skip = emitted[:, cut:], self._skip - cut
        return emitted

    @torch.inference_mode()
    def process(self, block) -> torch.Tensor:
        """block (hop,) or (1, hop) new samples -> (n_sources, emitted) float32 on the device.

        The emitted length varies around hop at the stream head (latent delay
        and hop-grid staging); all emissions and `finish()` concatenated give
        the offline output.
        """
        block = self._samples(block)
        if block.shape != (1, self.hop):
            raise ValueError(f"blocks must be exactly hop={self.hop} samples, got "
                             f"{tuple(block.shape)}")
        buf = torch.cat([self._pending, block], dim=-1)
        n_f = (buf.shape[-1] - self.L) // self.S + 1
        n_use = n_f // self.P * self.P  # >= P: the hop was checked against it
        self._pending = buf[:, n_use * self.S:]
        return self._separate(self._encode(buf[:, :(n_use - 1) * self.S + self.L]))

    def flush(self) -> torch.Tensor:
        """Emit the decoder's overlap-add tail (kernel_size - stride samples)."""
        out, self._tail = self._tail, torch.zeros_like(self._tail)
        return out

    @torch.inference_mode()
    def finish(self, block=None) -> torch.Tensor:
        """End the stream with a final block of any length; emit everything that remains.

        The leftover samples must land on the stride grid ((total - L) % S
        == 0), as the offline forward's own padding does. Latent frames off
        the hop grid are padded to one hop at the latent level inside the
        separator (the offline right pad) and trimmed. The separator is then
        reset for a new stream.
        """
        parts = [self._pending] + ([] if block is None else [self._samples(block)])
        buf = torch.cat(parts, dim=-1)
        n_f = 0
        if buf.shape[-1] >= self.L:
            if (buf.shape[-1] - self.L) % self.S:
                raise ValueError(f"the final block leaves {buf.shape[-1]} samples, off the "
                                 f"stride grid (L={self.L}, S={self.S})")
            n_f = (buf.shape[-1] - self.L) // self.S + 1
        n_full = n_f // self.P * self.P
        pieces = []
        if n_full:
            pieces.append(self._separate(self._encode(buf[:, :(n_full - 1) * self.S + self.L])))
        # The final separator call on the r < P leftover frames (possibly none)
        # emits a mask for every latent frame still waiting in the delay line.
        w = self._encode(buf[:, n_full * self.S:]) if n_f > n_full else self._w_delay[:, :0]
        if self._w_delay.shape[1] + w.shape[1]:
            pieces.append(self._separate(w))
        if self._w_delay.shape[1]:
            raise RuntimeError(f"the final call left {self._w_delay.shape[1]} latent frames "
                               "without a mask")
        pieces.append(self.flush())
        self.reset()
        return torch.cat(pieces, dim=-1)
