"""The port's hub: reference-format checkpoints opened by `hub/torch_checkpoint.py` and
`hub/pretrained.py`, against the JAX package's `build_from_torch_checkpoint`.

A reference checkpoint is the model's config keys beside its `state_dict`, with no
`model_class`. Each case writes a tiny seed-drawn port model that way (its BatchNorm
statistics moved off their start), opens it with JAX's dispatch and with the port's on the
CPU, and holds the class each picks and the forwards (at 1e-4 x max|JAX|), and the port's
loaded state bit for bit. ParallelOpenUnmix (its `backbone.*` keys open as X-UMX in both)
and GRU / stream-safe DPRNN-TasNet (neither dispatch passes `rnn_type` or `stream_safe`)
are the hazards the port mirrors: the first opens as a bridged X-UMX in both; the second
fails the port's strict load, and JAX's dispatch builds an LSTM model for it whose forward
fails on the GRU's parameter shapes.

The reference's MRX writes its encoders' unapplied input affine (`encoder_blocks.{i}.scale_in`,
`.bias_in`), which JAX's converter drops and the port leaves out of its strict load by name:
the "mrx-reference" case writes them beside the port's state (one value a bin; the port
drops them by name, whatever their shape), and a stray key beside them still fails the load.

A GRU MMDenseRNN is the one family whose JAX conversion cannot run (JAX's
`convert_mm_dense_rnn` writes LSTM parameters whatever the `rnn_type`): its checkpoint is
written from JAX-drawn variables through `hub/from_jax.py`, and the port's forward is held
to JAX's MMDenseRNN on those variables; JAX's dispatch is held to the class it picks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch import models
from dnn_based_source_separation_torch.hub import (
    build_from_pretrained, build_from_torch_checkpoint, mm_dense_rnn_state_dict_from_jax,
)
from dnn_based_source_separation_tpu.hub.torch_convert import (
    build_from_torch_checkpoint as jax_build_from_torch_checkpoint,
)
from dnn_based_source_separation_tpu.models.mm_dense_rnn import MMDenseRNN as JMMDenseRNN

TOL = 1e-4  # x max|JAX|, f32
WAVE = dict(n_basis=16, kernel_size=4, stride=2, n_sources=2)
BANDS = dict(in_channels=2, kernel_size={"low": 3, "high": 3, "full": 3}, bands=("low", "high"),
             sections=(5, 6), scale={"low": 2, "high": 2, "full": 2}, growth_rate_final=3,
             kernel_size_final=3)
MMDENSE = dict(BANDS, num_features={"low": 4, "high": 3, "full": 3},
               growth_rate={"low": (3, 3, 3), "high": (2, 2, 2), "full": (3, 2, 3)},
               depth={"low": (2, 1, 1), "high": (1, 1, 1), "full": (1, 1, 1)}, depth_final=1)
MMDENSE_RNN = dict(MMDENSE, hidden_channels={"low": (0, 4, 0), "high": (0, 3, 0),
                                             "full": (0, 0, 4)})
D3NET = dict(MMDENSE, num_d2blocks={"low": (2, 1, 1), "high": (1, 1, 1), "full": (1, 2, 1)})
UMX = dict(in_channels=2, hidden_channels=16, num_layers=2, n_bins=33, max_bin=20)
SPEC = dict(n_bins=33, embed_dim=4, hidden_channels=8, num_blocks=2)

# family: (the class both dispatches pick, its config, the inputs' kind)
FAMILIES = {
    "conv-tasnet": ("ConvTasNet", dict(WAVE, kernel_size=8, stride=4, enc_nonlinear="relu",
                                       sep_num_blocks=2, sep_num_layers=3,
                                       sep_hidden_channels=20, sep_bottleneck_channels=12,
                                       sep_skip_channels=12), "wave"),
    "dprnn-tasnet": ("DPRNNTasNet", dict(WAVE, enc_nonlinear="relu", sep_bottleneck_channels=8,
                                         sep_hidden_channels=12, sep_chunk_size=10,
                                         sep_hop_size=5, sep_num_blocks=2), "wave"),
    "dptnet": ("DPTNet", dict(WAVE, enc_nonlinear="relu", sep_bottleneck_channels=8,
                              sep_hidden_channels=12, sep_chunk_size=10, sep_num_blocks=2,
                              sep_num_heads=2), "wave"),
    "lstm-tasnet": ("LSTMTasNet", dict(WAVE, kernel_size=8, stride=4, sep_num_blocks=2,
                                       sep_num_layers=2, sep_hidden_channels=16), "wave"),
    "sepformer": ("SepFormer", dict(WAVE, sep_bottleneck_channels=8, sep_chunk_size=10,
                                    sep_hop_size=5, sep_num_blocks=2, sep_num_layers_intra=2,
                                    sep_num_layers_inter=1, sep_num_heads_intra=2,
                                    sep_num_heads_inter=2, sep_d_ff_intra=16,
                                    sep_d_ff_inter=12), "wave"),
    "galrnet": ("GALRNet", dict(WAVE, sep_hidden_channels=16, sep_chunk_size=10,
                                sep_hop_size=5, sep_down_chunk_size=4, sep_num_blocks=2,
                                sep_num_heads=2), "wave"),
    "open-unmix": ("OpenUnmix", UMX, "umx"),
    "x-umx": ("CrossNetOpenUnmix", dict(UMX, sources=("bass", "vocals")), "xumx"),
    "mrx": ("MultiResolutionCrossNet", dict(in_channels=2, hidden_channels=16, num_layers=2,
                                            sources=("a", "b", "c"), n_fft=(32, 64),
                                            hop_length=16), "stereo"),
    "mrx-reference": ("MultiResolutionCrossNet", dict(in_channels=2, hidden_channels=16,
                                                      num_layers=2, sources=("a", "b", "c"),
                                                      n_fft=(32, 64), hop_length=16), "stereo"),
    "d3net": ("D3Net", D3NET, "band"),
    "mm-densenet": ("MMDenseNet", MMDENSE, "band"),
    "mm-dense-lstm": ("MMDenseLSTM", MMDENSE_RNN, "band"),
    "mm-dense-gru": ("MMDenseRNN", dict(MMDENSE_RNN, rnn_type="gru", causal=True), "band"),
    "danet": ("DANet", SPEC, "danet"),
    "adanet": ("ADANet", dict(SPEC, num_anchors=4), "adanet"),
}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")  # JAX's recurrences in lax.scan


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "wave":
        return (rng.standard_normal((2, 1, 203)).astype(np.float32),)
    if kind == "stereo":
        return (rng.standard_normal((1, 2, 200)).astype(np.float32),)
    if kind in ("umx", "xumx"):
        lead = (2, 1) if kind == "xumx" else (2,)
        return (np.abs(rng.standard_normal((*lead, 2, 33, 19))).astype(np.float32),)
    if kind == "band":
        return (np.abs(rng.standard_normal((1, 2, 11, 9))).astype(np.float32),)
    src = rng.random((2, 2, 33, 21)).astype(np.float32) ** 2
    mix = src.sum(axis=1, keepdims=True)
    weight = (mix > np.median(mix)).astype(np.float32)
    if kind == "adanet":
        return mix, weight
    assign = np.moveaxis(np.eye(2, dtype=np.float32)[src.argmax(axis=1)], -1, 1)
    return mix, assign, weight


def _mrx_encoder_affine(config, seed):
    """The reference MRX's encoder input affine, one (scale, bias) a resolution."""
    rng = np.random.default_rng(seed)
    return {f"encoder_blocks.{i}.{name}": torch.from_numpy(
        rng.standard_normal(n_fft // 2 + 1).astype(np.float32))
        for i, n_fft in enumerate(config["n_fft"]) for name in ("scale_in", "bias_in")}


def _reference_checkpoint(path, cls_name, config, seed, extra=None):
    """A seed-drawn port model written in the reference layout: config keys and the
    `state_dict` (with the reference-only tensors `extra` beside it), no `model_class`.
    -> the port model's state."""
    model = models.base.get_model_class(cls_name)(**config,
                                                  generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # BatchNorm statistics away from their start
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(seed))
            elif name.endswith("running_mean"):
                buf.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(seed))
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save({**model.get_config(), "state_dict": {**state, **(extra or {})}}, path)
    return state


def _reference_checkpoint_from_jax(path, config, x):
    """A GRU MMDenseRNN's JAX variables (drawn at their init's shapes, statistics off their
    start) written in the reference layout -> the variables."""
    jmodel = JMMDenseRNN(**config)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    rng = np.random.default_rng(6)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: (rng.uniform(0.5, 1.5, s.shape) if "var" in str(p[-1]) else
                      0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    port = models.MMDenseRNN(**config)
    torch.save({**port.get_config(), "state_dict": mm_dense_rnn_state_dict_from_jax(
        variables, config)}, path)
    return variables


@pytest.mark.parametrize("family", list(FAMILIES))
def test_reference_checkpoint_opens_as_jax_opens_it(tmp_path, family):
    cls_name, config, kind = FAMILIES[family]
    path = str(tmp_path / f"{family}.pth")
    inputs = _inputs(kind, seed=5)
    if family == "mm-dense-gru":
        variables = _reference_checkpoint_from_jax(path, config, inputs[0])
        state = {k: v.clone() for k, v in torch.load(path, weights_only=True)["state_dict"].items()}
        jmodel = jax_build_from_torch_checkpoint(path)[0]
    else:
        extra = _mrx_encoder_affine(config, seed=4) if family == "mrx-reference" else None
        state = _reference_checkpoint(path, cls_name, config, seed=3, extra=extra)
        jmodel, variables = jax_build_from_torch_checkpoint(path)
    assert "model_class" not in torch.load(path, weights_only=True)
    model = build_from_torch_checkpoint(path, device="cpu")
    assert type(jmodel).__name__ == type(model).__name__ == cls_name
    assert not model.training and next(model.parameters()).device.type == "cpu"
    loaded = model.state_dict()
    assert loaded.keys() == state.keys()
    for name, value in state.items():
        assert torch.equal(loaded[name], value), name

    extra = (2,) if kind == "adanet" else ()
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    ref = np.asarray(jax.jit(lambda v, *a: jmodel.apply(v, *a, *extra))(
        variables, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, inputs), *extra).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()


def test_only_the_named_reference_keys_are_left_out(tmp_path):
    _, config, _ = FAMILIES["mrx-reference"]
    path = str(tmp_path / "stray.pth")
    extra = _mrx_encoder_affine(config, seed=4)
    _reference_checkpoint(path, "MultiResolutionCrossNet", config, seed=3,
                          extra={**extra, "encoder_blocks.0.stray": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="encoder_blocks.0.stray"):
        build_from_torch_checkpoint(path, device="cpu")


def test_mirrored_hazards(tmp_path):
    # A GRU DPRNN-TasNet: built as an LSTM one, its weights do not fit.
    _, config, _ = FAMILIES["dprnn-tasnet"]
    path = str(tmp_path / "gru.pth")
    _reference_checkpoint(path, "DPRNNTasNet", dict(config, rnn_type="gru"), seed=1)
    with pytest.raises(RuntimeError, match="DPRNNTasNet"):
        build_from_torch_checkpoint(path, device="cpu")
    jmodel, variables = jax_build_from_torch_checkpoint(path)
    assert type(jmodel).__name__ == "DPRNNTasNet" and jmodel.rnn_type == "lstm"
    with pytest.raises(Exception, match="w_ih_l0"):
        jmodel.apply(variables, jnp.zeros((1, 1, 203)))
    # ParallelOpenUnmix: its backbone.* keys select X-UMX, which its weights fit: it opens
    # as the bridged X-UMX in both.
    path = str(tmp_path / "parallel.pth")
    state = _reference_checkpoint(path, "ParallelOpenUnmix",
                                  dict(UMX, sources=("bass", "vocals")), seed=1)
    model = build_from_torch_checkpoint(path, device="cpu")
    jmodel = jax_build_from_torch_checkpoint(path)[0]
    assert type(model).__name__ == type(jmodel).__name__ == "CrossNetOpenUnmix"
    assert model.bridge and jmodel.bridge
    assert all(torch.equal(model.state_dict()[k], v) for k, v in state.items())


def test_build_from_pretrained_layout_fetcher_and_missing_file(tmp_path):
    cls_name, config, _ = FAMILIES["conv-tasnet"]
    root = tmp_path / "pretrained"
    path = root / "wsj0-mix" / "sr8000" / "2speakers" / "best.pth"
    path.parent.mkdir(parents=True)
    state = _reference_checkpoint(str(path), cls_name, config, seed=2)
    model = build_from_pretrained(root=str(root), device="cpu")
    assert type(model).__name__ == cls_name
    calls = []

    def fetcher(**kwargs):
        calls.append(kwargs)
        return str(path)

    fetched = build_from_pretrained(task="wsj0-mix", sample_rate=8000, n_sources=2,
                                    model_choice="best", fetcher=fetcher, device="cpu")
    assert calls == [dict(task="wsj0-mix", sample_rate=8000, n_sources=2, model_choice="best")]
    for name, value in state.items():
        assert torch.equal(model.state_dict()[name], value)
        assert torch.equal(fetched.state_dict()[name], value)
    with pytest.raises(FileNotFoundError, match="pretrained checkpoint not found"):
        build_from_pretrained(root=str(root), model_choice="last", device="cpu")
    with pytest.raises(FileNotFoundError, match="pretrained checkpoint not found"):
        build_from_pretrained(fetcher=lambda **_: str(tmp_path / "nowhere.pth"), device="cpu")


def test_the_card_is_the_default_and_is_required(tmp_path):
    cls_name, config, _ = FAMILIES["conv-tasnet"]
    path = str(tmp_path / "model.pth")
    _reference_checkpoint(path, cls_name, config, seed=2)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_from_torch_checkpoint(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_from_pretrained(fetcher=lambda **_: path)
