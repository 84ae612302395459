"""The port's FurcaNet against the JAX package, and through the port's CLIs (CPU).

- `GatedConvNet` and `FurcaNet`, causal (cLNs) or not (gLNs), with weights from
  `hub/from_jax.py:furcanet_state_dict_from_jax`: forward and every parameter's gradient
  at TOL x max|ref| in f32 (JAX's LSTM on `lax.scan`, `DNNTPU_PALLAS_LSTM=0`);
- the port's recipe shell (`egs/wsj0-mix/furcanet/train.sh` inside the package: -Hc 128
  -Hr 128 -Bc 6 -Br 6, k = 3) parsed to the JAX recipe's arguments, and the factory's model
  against the JAX factory's config;
- `cli/train_wsj0mix.py --model furcanet` at tiny widths on a synthetic corpus: its
  checkpoint through `load_model` and `cli/separate.py`, equal to the trained model's
  forward.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.cli import train_wsj0mix as ttrain
from dnn_based_source_separation_torch.cli.model_factory import build_wsj0mix_model
from dnn_based_source_separation_torch.hub import furcanet_state_dict_from_jax
from dnn_based_source_separation_torch.models import FurcaNet
from dnn_based_source_separation_torch.models.base import load_model
from dnn_based_source_separation_torch.models.furcanet import GatedConvNet
from dnn_based_source_separation_tpu.cli import train_wsj0mix as jtrain
from dnn_based_source_separation_tpu.cli.model_factory import (
    build_wsj0mix_model as jax_build_wsj0mix_model,
)
from dnn_based_source_separation_tpu.data.audio_io import read_wav, write_wav
from dnn_based_source_separation_tpu.models import furcanet as jfurcanet
from test_torch_bench import _recipe_argv

TOL = 1e-4
CFG = dict(conv_hidden_channels=8, rnn_hidden_channels=6, num_conv_blocks=3,
           num_rnn_blocks=2, kernel_size=3, n_sources=2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
RECIPE = "egs/wsj0-mix/furcanet/train.sh"


@pytest.fixture(autouse=True)
def _jax_scan(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _scramble(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _scramble(v, rng)
            continue
        v = np.asarray(v)
        if k == "gamma":
            v = 0.5 + rng.random(v.shape)
        elif k in ("beta", "bias") or k.startswith("b"):
            v = 0.3 * rng.standard_normal(v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("nonlinear", ["sigmoid", "relu"])
def test_furcanet_forward_and_grads_match_jax(causal, nonlinear):
    config = dict(CFG, causal=causal, nonlinear=nonlinear)
    x = np.random.default_rng(int(causal)).standard_normal((2, 1, 301)).astype(np.float32)
    jmodel = jfurcanet.FurcaNet(**config)
    params = _scramble(jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.asarray(x))["params"]), np.random.default_rng(5))
    port = FurcaNet(**config)
    port.load_state_dict(furcanet_state_dict_from_jax({"params": params}, config))
    y = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x)))
    got = port(torch.from_numpy(x))
    _close(got, y)
    g = np.random.default_rng(9).standard_normal(y.shape).astype(np.float32)

    def loss(p):
        return jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) * g)

    ref = furcanet_state_dict_from_jax(jax.jit(jax.grad(loss))(params), config)
    (got * torch.from_numpy(g)).sum().backward()
    for name, p in port.named_parameters():
        if p.requires_grad:
            _close(p.grad, ref[name])
    # The LSTM's bias_hh is frozen (JAX trains their sum), nothing else.
    frozen = {n for n, p in port.named_parameters() if not p.requires_grad}
    assert frozen == {n for n in frozen if ".bias_hh_" in n} and len(frozen) == 4


def test_gated_conv_net_is_causal_when_asked():
    x = torch.randn(1, 40, 1)
    for causal in (False, True):
        net = GatedConvNet(1, 4, num_blocks=2, causal=causal,
                           generator=torch.Generator().manual_seed(0))
        y, y_cut = net(x), net(x[:, :20])
        # causal: the first 20 outputs depend on the first 20 samples only (the cLN is
        # cumulative); the gLN's statistics read the whole input.
        assert torch.allclose(y[:, :20], y_cut, atol=1e-6) == causal


def test_factory_builds_the_recipe_as_jax_does():
    # The port's recipe shell and the JAX package's, each parsed by its own CLI's parser.
    module, argv = _recipe_argv(ROOT / "dnn_based_source_separation_torch" / RECIPE)
    jmodule, jargv = _recipe_argv(ROOT / RECIPE)
    assert (module, jmodule) == ("dnn_based_source_separation_torch.cli.train_wsj0mix",
                                 "dnn_based_source_separation_tpu.cli.train_wsj0mix")
    args = ttrain.build_parser().parse_args(argv)
    jargs = jtrain.build_parser().parse_args(jargv)
    assert args.device == "device" and "--device" not in jargv
    for name, value in vars(jargs).items():
        assert getattr(args, name) == value, name
    args.causal, jargs.causal = bool(args.causal), bool(jargs.causal)
    port = build_wsj0mix_model(args, "cpu")
    jmodel = jax_build_wsj0mix_model(jargs)
    assert isinstance(port, FurcaNet)
    config = port.get_config()
    for field in ("conv_hidden_channels", "rnn_hidden_channels", "num_conv_blocks",
                  "num_rnn_blocks", "kernel_size", "nonlinear", "norm", "causal", "n_sources",
                  "eps"):
        assert config[field] == getattr(jmodel, field), field
    assert (config["conv_hidden_channels"], config["num_rnn_blocks"], args.duration,
            args.batch_size) == (128, 6, 2.0, 4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsj0_furcanet")
    rng = np.random.default_rng(0)
    for split in ("tr", "cv"):
        for sub in ("mix", "s1", "s2"):
            os.makedirs(root / split / sub)
        utts = []
        for i in range(3):
            s1, s2 = 0.1 * rng.standard_normal(800), 0.1 * rng.standard_normal(800)
            utt = f"{split}{i}"
            write_wav(str(root / split / "s1" / f"{utt}.wav"), s1, 8000)
            write_wav(str(root / split / "s2" / f"{utt}.wav"), s2, 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), s1 + s2, 8000)
            utts.append(utt)
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


def test_train_cli_trains_serves_and_reopens_furcanet(corpus, tmp_path):
    exp = tmp_path / "exp"
    argv = ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--duration", "0.05", "--valid_duration", "0.1", "--batch_size", "2",
            "--epochs", "1", "--exp_dir", str(exp), "--device", "cpu", "--model", "furcanet",
            "-Hc", "8", "-Hr", "6", "-Bc", "2", "-Br", "2", "--causal", "1"]
    trainer = ttrain.main(argv)
    assert np.isfinite(trainer.train_loss[0]) and np.isfinite(trainer.valid_loss[0])
    ckpt = str(exp / "model" / "last.ckpt")
    model = load_model(ckpt)
    assert isinstance(model, FurcaNet) and model.causal
    wav = str(corpus / "cv" / "mix" / "cv0.wav")
    est = tsep.main(["--model_path", ckpt, "--input", wav, "--out_dir", str(tmp_path / "out"),
                     "--device", "cpu"])
    x = read_wav(wav)[0]
    with torch.no_grad():
        ref = model(torch.from_numpy(np.asarray(x, np.float32))[None, None])[0].numpy()
    _close(est, ref, 1e-6)
    with torch.no_grad():
        trained = trainer.model.eval()(torch.from_numpy(np.asarray(x, np.float32))[None, None])
    _close(trained[0], ref, 1e-6)
