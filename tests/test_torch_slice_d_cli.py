"""LSTM-TasNet, SepFormer and GALRNet through the port's CLIs, factory, recipes and bench (CPU).

- `cli/train_wsj0mix.py --model lstm-tasnet|sepformer|galrnet` at tiny widths on a
  synthetic corpus for one epoch, resumed for a second, its checkpoint served through
  `cli/separate.py` (offline, `--chunk_duration`, and for causal LSTM-TasNet with the
  trainable encoder `--streaming_hop`, equal to the offline output), evaluated
  through `cli/test_wsj0mix.py`, and opened in JAX (`build_from_torch_checkpoint`),
  where it computes the port's function within 1e-4 x max|ref|;
- the factory builds each recipe (the port's recipe shells parsed by the port's
  parser) with the JAX factory's arguments and defaults: every config field the JAX
  model has is equal;
- the bench's multiply-add counts against `torch.utils.flop_counter`, the recipe
  configs' counts by hand, and its JSON lines at tiny widths.
"""
import os
import pathlib
import re
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dnn_based_source_separation_torch import bench
from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.cli import test_wsj0mix as ttest
from dnn_based_source_separation_torch.cli import train_wsj0mix as ttrain
from dnn_based_source_separation_torch.cli.model_factory import build_wsj0mix_model
from dnn_based_source_separation_torch.models import GALRNet, LSTMTasNet, SepFormer
from dnn_based_source_separation_torch.models.base import load_model
from dnn_based_source_separation_tpu.cli.model_factory import (
    build_wsj0mix_model as jax_build_wsj0mix_model,
)
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.hub.torch_convert import build_from_torch_checkpoint

RECIPES = pathlib.Path(bench.__file__).resolve().parent / "egs" / "wsj0-mix"
CLASSES = {"lstm-tasnet": LSTMTasNet, "sepformer": SepFormer, "galrnet": GALRNet}
CLI_MODELS = {
    "lstm-tasnet": ["--model", "lstm-tasnet", "-N", "16", "-L", "8",
                    "--enc_basis", "trainableGated", "--sep_num_blocks", "2",
                    "--sep_num_layers", "1", "-H", "8", "--mask_nonlinear", "softmax"],
    "lstm-tasnet-causal": ["--model", "lstm-tasnet", "-N", "16", "-L", "8",
                           "--enc_basis", "trainable", "--sep_num_blocks", "1",
                           "--sep_num_layers", "2", "-H", "8", "--mask_nonlinear", "sigmoid",
                           "--causal", "1"],
    "sepformer": ["--model", "sepformer", "-N", "16", "-L", "4", "-B", "8", "-K", "10",
                  "--sep_hop_size", "5", "--sep_num_blocks", "1", "--sep_num_layers", "1",
                  "--sep_num_heads", "2", "--mask_nonlinear", "relu"],
    "galrnet": ["--model", "galrnet", "-N", "16", "-L", "4", "-K", "10", "--sep_hop_size", "5",
                "-Q", "4", "--sep_num_blocks", "2", "--sep_num_heads", "2", "-H", "8",
                "--mask_nonlinear", "relu"],
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsj0")
    rng = np.random.default_rng(0)
    for split in ("tr", "cv"):
        for sub in ("mix", "s1", "s2"):
            os.makedirs(root / split / sub)
        utts = []
        for i in range(3):
            s1, s2 = 0.1 * rng.standard_normal(4000), 0.1 * rng.standard_normal(4000)
            utt = f"{split}{i}"
            write_wav(str(root / split / "s1" / f"{utt}.wav"), s1, 8000)
            write_wav(str(root / split / "s2" / f"{utt}.wav"), s2, 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), s1 + s2, 8000)
            utts.append(utt)
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


def _args(corpus, exp, *extra):
    return ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--duration", "0.25", "--valid_duration", "0.5", "--batch_size", "2",
            "--exp_dir", str(exp), "--device", "cpu", *extra]


@pytest.mark.parametrize("model", sorted(CLI_MODELS))
def test_cli_trains_resumes_serves_and_evaluates(corpus, tmp_path, model):
    flags = CLI_MODELS[model]
    exp = tmp_path / "exp"
    trainer = ttrain.main(_args(corpus, exp, "--epochs", "1", *flags))
    assert type(trainer.model) is CLASSES[flags[1]]
    assert trainer.model.causal == ("--causal" in flags)
    assert len(trainer.train_loss) == 1 and all(np.isfinite(trainer.train_loss
                                                            + trainer.valid_loss))
    last = exp / "model" / "last.ckpt"
    resumed = ttrain.main(_args(corpus, exp, "--epochs", "2", "--continue_from", str(last),
                                *flags))
    assert resumed.start_epoch == 1 and len(resumed.train_loss) == 2
    assert all(np.isfinite(resumed.train_loss + resumed.valid_loss))

    wav = str(corpus / "cv" / "mix" / "cv0.wav")
    served = {}
    runs = [[], ["--chunk_duration", "0.2"]]
    if "--causal" in flags:
        runs.append(["--streaming_hop", "0.05"])
    for run in runs:
        est = tsep.main(["--model_path", str(last), "--input", wav, "--out_dir",
                         str(tmp_path / "sep"), "--device", "cpu", *run])
        assert est.shape == (2, 4000) and np.isfinite(est).all()
        served[tuple(run)] = est
    if "--causal" in flags:  # streamed hop by hop == the offline forward
        ref = served[()]
        streamed = served[("--streaming_hop", "0.05")]
        assert np.abs(streamed - ref).max() <= 1e-5 * np.abs(ref).max()
    result = ttest.main(["--test_wav_root", str(corpus / "cv"), "--test_list_path",
                         str(corpus / "cv.lst"), "--model_path", str(last), "--device", "cpu"])
    for key in ("loss", "loss_improvement", "sdr_improvement", "sir_improvement", "sar"):
        assert np.isfinite(result[key]), (key, result)

    # The trained checkpoint opens in JAX and computes the same function there.
    jmodel, jparams = build_from_torch_checkpoint(str(last))
    x = np.random.default_rng(1).standard_normal((1, 1, 400)).astype(np.float32)
    with torch.no_grad():
        got = load_model(str(last))(torch.from_numpy(x)).numpy()
    expected = np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x)))
    assert np.abs(got - expected).max() <= 1e-4 * np.abs(expected).max()


def _recipe_argv(path):
    """The arguments a recipe shell passes to its CLI, its variables given values."""
    text = path.read_text()
    command = re.search(r"python -m (\S+) \\\n(.*?)\| tee", text, re.S)
    module, body = command.group(1), command.group(2).replace("\\\n", " ")
    body = re.sub(r'"\$\{?(\w+)\}?([^"]*)"', lambda m: f"{m.group(1)}{m.group(2)}", body)
    return module, [a for a in shlex.split(body) if a != "$@"]


RECIPE_FLAGS = {  # egs/wsj0-mix/<model>/train.sh of the JAX package
    "lstm-tasnet": "-N 500 -L 40 --enc_basis trainableGated --sep_num_blocks 2 "
                   "--sep_num_layers 2 --sep_hidden_channels 500 --mask_nonlinear softmax",
    "sepformer": "-N 256 -L 16 -K 250 --sep_hop_size 125 --sep_num_blocks 2 --sep_num_layers 8 "
                 "--sep_num_heads 8 --sep_bottleneck_channels 256 --mask_nonlinear relu",
    "galrnet": "-N 64 -L 16 -K 100 --sep_hop_size 50 -Q 32 --sep_num_blocks 6 --sep_num_heads 8 "
               "--sep_hidden_channels 128 --mask_nonlinear relu",
}


@pytest.mark.parametrize("causal", ["0", "1"])
@pytest.mark.parametrize("model", sorted(RECIPE_FLAGS))
def test_recipes_build_as_the_jax_factory_builds_them(model, causal):
    module, argv = _recipe_argv(RECIPES / model / "train.sh")
    assert module == "dnn_based_source_separation_torch.cli.train_wsj0mix"
    assert " ".join(a for a in argv if a not in ("--device", "device")).endswith(
        RECIPE_FLAGS[model])
    args = ttrain.build_parser().parse_args(argv + ["--causal", causal])
    assert args.model == model and args.device == "device" and args.batch_size == 4
    args.causal = bool(int(args.causal))
    port = build_wsj0mix_model(args, "meta")
    jmodel = jax_build_wsj0mix_model(args)
    assert type(port) is CLASSES[model] and type(jmodel).__name__ == type(port).__name__
    config = port.get_config()
    for key, value in config.items():
        assert value == getattr(jmodel, key), key
    module, argv = _recipe_argv(RECIPES / model / "test.sh")
    assert module == "dnn_based_source_separation_torch.cli.test_wsj0mix"
    assert ttest.build_parser().parse_args(argv).model_path.endswith(".ckpt")


TINY = {
    "lstm-tasnet": dict(bench.LSTM_TASNET, n_basis=16, kernel_size=8, sep_hidden_channels=8,
                        sep_num_layers=1),
    "sepformer": dict(bench.SEPFORMER, n_basis=16, kernel_size=4, sep_bottleneck_channels=8,
                      sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=1,
                      sep_num_layers_intra=2, sep_num_layers_inter=1, sep_num_heads_intra=2,
                      sep_num_heads_inter=2, sep_d_ff_intra=16, sep_d_ff_inter=12),
    "galrnet": dict(bench.GALRNET, n_basis=16, kernel_size=4, sep_hidden_channels=8,
                    sep_chunk_size=10, sep_hop_size=5, sep_down_chunk_size=4, sep_num_blocks=2,
                    sep_num_heads=2),
}


def _counted(model, T, batch):
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(torch.randn(batch, 1, T))
    return counter.get_total_flops()


VARIANTS = [(model, variant) for model in sorted(TINY)
            for variant in (dict(), dict(causal=True), dict(enc_basis="trainable"),
                            dict(sep_down_chunk_size=None))
            if set(variant) <= set(TINY[model]) | {"causal"}]


@pytest.mark.parametrize("model,variant", VARIANTS,
                         ids=[f"{m}-{'-'.join(v) or 'recipe'}" for m, v in VARIANTS])
def test_flops_match_the_flop_counter(model, variant):
    net = CLASSES[model](**dict(TINY[model], **variant),
                         generator=torch.Generator().manual_seed(0)).eval()
    assert bench.forward_flops(net, 203, batch=2) == {"matmul": _counted(net, 203, 2),
                                                      "depthwise": 0}


def test_recipe_flops_from_the_config():
    """B = 8 x 4 s, multiply-adds by hand. LSTM-TasNet: T' = 1599 frames, the gated encoder
    2 x 40 x 500, four biLSTM layers (the first from N = 500, the rest from 1000), fc
    1000 x 1000, decoder 2 x 500 x 40. SepFormer: T' = 3999 frames, 31 chunks of 250 (7750
    positions); GALRNet: T' = 3999, 79 chunks of 100 (7900 positions, Q = 32)."""
    lstm = 2 * (4 * 500 * 500 + 4 * 500 * 500) + 3 * 2 * (4 * 500 * 1000 + 4 * 500 * 500)
    per_frame = 2 * 40 * 500 + lstm + 1000 * 1000 + 2 * 500 * 40
    got = bench.forward_flops(LSTMTasNet(**bench.LSTM_TASNET, device="meta"), 32000, 8)
    assert got == {"matmul": 2 * 8 * 1599 * per_frame, "depthwise": 0}

    E = 256
    layer = 4 * E * E + 2 * E * 1024  # projections and feed-forward a position
    positions = 31 * 250
    stack = 8 * positions * (layer + 2 * E * 250) + 8 * positions * (layer + 2 * E * 31)
    per_frame = 16 * 256 + 256 * E + E * 512 + 3 * 2 * 256 * 256 + 2 * 256 * 16
    got = bench.forward_flops(SepFormer(**bench.SEPFORMER, device="meta"), 32000, 8)
    assert got == {"matmul": 2 * 8 * (3999 * per_frame + 2 * stack), "depthwise": 0}

    N, H = 64, 128
    block = 7900 * (2 * (4 * H * N + 4 * H * H) + 2 * H * N)  # intra biLSTM and fc
    block += 79 * 32 * (4 * N * N + 2 * N * 79) + 2 * 79 * N * 100 * 32  # attention, fc_map/inv
    per_frame = 16 * 64 + 64 * 128 + 2 * 2 * 64 * 64 + 2 * 64 * 16
    got = bench.forward_flops(GALRNet(**bench.GALRNET, device="meta"), 32000, 8)
    assert got == {"matmul": 2 * 8 * (3999 * per_frame + 6 * block), "depthwise": 0}


@pytest.fixture
def tiny_bench(monkeypatch):
    monkeypatch.setattr(bench, "SECONDS", 0.25)
    monkeypatch.setattr(bench, "CONFIGS", dict(bench.CONFIGS, **TINY))


@pytest.mark.parametrize("model", sorted(TINY))
def test_bench_json_lines(tiny_bench, model):
    line = bench.main(["--device", "cpu", "--model", model, "--dtype", "float32"])
    assert line["metric"] == f"{model.replace('-', '_')}_wsj0mix_inference_rtf"
    assert line["value"] > 0 and line["ms"] > 0 and line["mfu"] is None
    assert line["flops"] == sum(bench.forward_flops(
        CLASSES[model](**TINY[model], device="meta"), 2000, bench.BATCH).values())
    if model == "lstm-tasnet":  # streams causal with the trainable encoder
        hop = bench.main(["--device", "cpu", "--model", model, "--causal", "--streaming_hop",
                          "0.05", "--dtype", "float32"])
        assert hop["metric"] == "lstm_tasnet_streaming_ms_per_hop" and hop["hops"] == 5
    else:
        with pytest.raises(NotImplementedError, match="attention-based"):
            bench.main(["--device", "cpu", "--model", model, "--causal", "--streaming_hop",
                        "0.05"])
