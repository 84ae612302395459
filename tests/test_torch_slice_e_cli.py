"""musdb18's 2-D dense / U-Net recipes through the port's CLIs (CPU).

- `cli/train_musdb18.py --device cpu` trains D3Net, MMDenseNet and MMDenseLSTM (from
  band-structured YAMLs at tiny widths, written as the recipe YAMLs are), HRNet (one stem,
  `--target`) and CUNet (every stem's one-hot in one batch) for one step; the checkpoint
  reopens through `load_model` and computes the trained model's function;
- `cli/test_musdb18.py --device cpu` on a D3Net and an MMDenseLSTM checkpoint (the train
  CLI's model) against the JAX package's CLI on the same weights (the port's state dict through JAX's
  `convert_d3net` / `convert_mm_dense_rnn`, stem by stem): the stems at 1e-4 x max|ref|,
  the medians within 0.01 dB;
- the same CLI refuses HRNet and CUNet checkpoints, which have no stem list (JAX's CLI
  fails on them too);
- the port's recipe shells (`egs/musdb18/{d3net,mm-densenet,mm-dense-lstm,hrnet,cunet}`)
  parse to the JAX recipes' arguments.
"""
import pathlib

import jax
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import test_musdb18 as test_cli
from dnn_based_source_separation_torch.cli import train_musdb18 as cli
from dnn_based_source_separation_torch.data.synthetic import write_musdb_quality_corpus
from dnn_based_source_separation_torch.models import (
    ConditionedSpectrogramWrapper, ConditionedUNet2d, HRNet, ParallelD3Net,
    ParallelMMDenseLSTM, ParallelMMDenseNet, SingleStemSpectrogramWrapper,
    SpectrogramMaskingWrapper,
)
from dnn_based_source_separation_torch.models.base import load_model, read_checkpoint, save_model
from dnn_based_source_separation_torch.train.tester import Evaluater
from dnn_based_source_separation_tpu.cli import test_musdb18 as jtest_cli
from dnn_based_source_separation_tpu.cli import train_musdb18 as jcli
from dnn_based_source_separation_tpu.hub.torch_convert import convert_d3net, convert_mm_dense_rnn
from dnn_based_source_separation_tpu.models import d3net as jd3net
from dnn_based_source_separation_tpu.models import mm_dense_rnn as jrnn
from dnn_based_source_separation_tpu.models import wrappers as jwrappers
from dnn_based_source_separation_tpu.models.base import save_model as jax_save_model
from dnn_based_source_separation_tpu.train import tester as jtester
from test_torch_bench import _recipe_argv

SR, N_FFT, HOP = 8000, 64, 16  # 33 bins
SOURCES = ("bass", "drums", "other", "vocals")
BAND = """  sections: {sections}
  num_features: 4
  growth_rate: {growth}
  kernel_size: {kernel}
  scale: 2
  depth: {depth}
"""
YAMLS = {
    "d3net": "# tiny D3Net\nin_channels: 2\nbands: [low, middle]\n"
             + "low:\n" + BAND.format(sections=13, growth="[3, 4, 3]", kernel=3,
                                      depth="[2, 1, 2]") + "  num_d2blocks: [2, 1, 1]\n"
             + "middle:\n" + BAND.format(sections=20, growth="[2, 2, 2]", kernel=3,
                                         depth="[1, 1, 1]") + "  num_d2blocks: [1, 1, 1]\n"
             + "full:\n" + BAND.format(sections=0, growth="[3, 2, 3]", kernel=3,
                                       depth="[1, 2, 1]") + "  num_d2blocks: [1, 1, 1]\n"
             + "final:\n  growth_rate: 3\n  kernel_size: 3\n  depth: 1\n",
    "mm-densenet": "in_channels: 2\nbands: [low, high]\n"
                   + "low:\n" + BAND.format(sections=16, growth="[3, 4, 3]", kernel="[4, 3]",
                                            depth="[2, 1, 2]")
                   + "high:\n" + BAND.format(sections=17, growth="[2, 2, 2]", kernel=3,
                                             depth="[1, 1, 1]")
                   + "full:\n" + BAND.format(sections=0, growth="[3, 2, 3]", kernel="[4, 3]",
                                             depth="[1, 2, 1]")
                   + "final:\n  growth_rate: 3\n  kernel_size: [2, 1]\n  depth: 2\n",
    "mm-dense-lstm": "in_channels: 2\nbands: [low, high]\ncausal: False\nrnn_type: lstm\n"
                     "rnn_position: after_dense\n"
                     + "low:\n" + BAND.format(sections=13, growth="[3, 3, 3]", kernel=3,
                                              depth="[2, 1, 1]")
                     + "  hidden_channels: [0, 4, 0]\n"
                     + "high:\n" + BAND.format(sections=20, growth="[2, 0, 2]", kernel=3,
                                               depth="[1, 0, 1]")
                     + "  hidden_channels: [0, 3, 0]\n"
                     + "full:\n" + BAND.format(sections=0, growth="[3, 2, 3]", kernel=3,
                                               depth="[1, 1, 1]")
                     + "  hidden_channels: [0, 0, 4]\n"
                     + "final:\n  growth_rate: 3\n  hidden_channels: 0\n  kernel_size: 3\n"
                       "  depth: 1\n",
}
FLAGS = {
    "d3net": ["--d3net_config", "{yaml}"],
    "mm-densenet": ["--mmdense_config", "{yaml}"],
    "mm-dense-lstm": ["--mmdense_config", "{yaml}"],
    "hrnet": ["--hrnet_hidden", "3,4", "--target", "drums", "--criterion", "mae"],
    "cunet": ["--cunet_channels", "2,3,4", "--cunet_control_channels", "4,6",
              "--conditioning", "pocm", "--criterion", "l1loss"],
}
CLASSES = {"d3net": (SpectrogramMaskingWrapper, ParallelD3Net),
           "mm-densenet": (SpectrogramMaskingWrapper, ParallelMMDenseNet),
           "mm-dense-lstm": (SpectrogramMaskingWrapper, ParallelMMDenseLSTM),
           "hrnet": (SingleStemSpectrogramWrapper, HRNet),
           "cunet": (ConditionedSpectrogramWrapper, ConditionedUNet2d)}


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("DNNTPU_PALLAS_LSTM", "0")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_musdb_quality_corpus(str(tmp_path_factory.mktemp("musdb_e")), n_train=2,
                                      n_valid=1, n_test=1, track_sec=1.0, sample_rate=SR)


def _yaml(tmp_path, model):
    path = tmp_path / f"{model}.yaml"
    path.write_text(YAMLS[model])
    return str(path)


def _train_argv(corpus, tmp_path, model):
    flags = [f.format(yaml=_yaml(tmp_path, model)) if "{yaml}" in f else f
             for f in FLAGS[model]]
    return ["--musdb18_root", corpus, "--sample_rate", str(SR), "--duration", "0.25",
            "--valid_duration", "0.5", "--samples_per_epoch", "2", "--model", model,
            "--n_fft", str(N_FFT), "--hop_length", str(HOP), "--batch_size", "2",
            "--epochs", "1", "--exp_dir", str(tmp_path / "exp"), "--device", "cpu", *flags]


@pytest.mark.parametrize("model", list(FLAGS))
def test_cli_trains_the_slice_e_models(corpus, tmp_path, model):
    trainer = cli.main(_train_argv(corpus, tmp_path, model))
    wrapper, base = CLASSES[model]
    assert type(trainer.model) is wrapper and type(trainer.model.base) is base
    assert np.isfinite(trainer.train_loss[0]) and np.isfinite(trainer.valid_loss[0])
    last = str(tmp_path / "exp" / "model" / "last.ckpt")
    assert read_checkpoint(last)["model_class"] == wrapper.__name__
    reopened = load_model(last)
    x = torch.randn(1, 1, 2, 1200, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = reopened(x), trainer.model.eval()(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stems = 1 if model == "hrnet" else len(SOURCES)
    assert got.shape == (1, stems, 2, N_FFT // 2 + 1, 1200 // HOP + 1)


def _checkpoints(tmp_path, model, corpus):
    """The train CLI's model (seed-drawn weights, BatchNorm statistics moved off their
    start) as a port checkpoint, and the same weights as a JAX checkpoint, converted stem by
    stem."""
    args = cli.build_parser().parse_args(_train_argv(corpus, tmp_path, model))
    port = cli.build_model_and_criterion(args, list(SOURCES), "cpu")[0]
    path = str(tmp_path / f"{model}.ckpt")
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
    save_model(path, port)
    config = port.base.get_config()
    convert, jcls = {"d3net": (convert_d3net, jd3net.ParallelD3Net),
                     "mm-dense-lstm": (convert_mm_dense_rnn, jrnn.ParallelMMDenseLSTM)}[model]
    state = port.state_dict()
    variables = {"params": {}, "batch_stats": {}}
    for source in SOURCES:
        prefix = f"base.net.{source}."
        sub = {k[len(prefix):]: v.numpy() for k, v in state.items() if k.startswith(prefix)}
        for key, tree in convert(sub, config).items():
            variables[key][f"net_{source}"] = tree
    variables = {k: {"base": v} for k, v in variables.items()}
    jmodel = jwrappers.SpectrogramMaskingWrapper(base=jcls(**config), n_fft=N_FFT,
                                                 hop_length=HOP)
    jpath = str(tmp_path / f"{model}_jax.ckpt")
    jax_save_model(jpath, jmodel, jax.tree_util.tree_map(np.asarray, variables))
    return path, jpath


def _record_estimates(monkeypatch, evaluater_cls):
    seen = []
    add_track = evaluater_cls.add_track

    def recording(self, references, estimates):
        seen.append(np.array(estimates))
        return add_track(self, references, estimates)

    monkeypatch.setattr(evaluater_cls, "add_track", recording)
    return seen


EVAL_FLAGS = ["--sample_rate", str(SR), "--duration", "1.0", "--filt_len", "64"]


@pytest.mark.parametrize("model", ["d3net", "mm-dense-lstm"])
def test_test_cli_matches_jax_cli(monkeypatch, corpus, tmp_path, model):
    path, jpath = _checkpoints(tmp_path, model, corpus)
    jseen = _record_estimates(monkeypatch, jtester.Evaluater)
    seen = _record_estimates(monkeypatch, Evaluater)
    jtable = jtest_cli.main(["--musdb18_root", corpus, "--model_path", jpath, *EVAL_FLAGS])
    table, stats = test_cli.run(["--musdb18_root", corpus, "--model_path", path, "--device",
                                 "cpu", *EVAL_FLAGS])
    assert len(seen) == len(jseen) == 1
    assert seen[0].shape == jseen[0].shape == (4, SR, 2)
    assert np.abs(seen[0] - jseen[0]).max() <= 1e-4 * np.abs(jseen[0]).max()
    assert list(table) == list(jtable) == list(SOURCES)
    for source, row in table.items():
        for metric in Evaluater.METRICS:
            assert abs(row[metric] - jtable[source][metric]) <= 0.01, (source, metric)
    assert [s["chunks"] for s in stats] == [1]


@pytest.mark.parametrize("model", ["hrnet", "cunet"])
def test_test_cli_refuses_models_with_no_stem_list(corpus, tmp_path, model):
    args = cli.build_parser().parse_args(_train_argv(corpus, tmp_path, model))
    path = str(tmp_path / f"{model}.ckpt")
    save_model(path, cli.build_model_and_criterion(args, list(SOURCES), "cpu")[0])
    name = CLASSES[model][1].__name__
    with pytest.raises(ValueError, match=f"{name} has no stem list"):
        test_cli.run(["--musdb18_root", corpus, "--model_path", path, "--device", "cpu",
                      *EVAL_FLAGS])


def test_band_models_need_their_yaml(corpus, tmp_path):
    argv = [a for a in _train_argv(corpus, tmp_path, "d3net") if not a.endswith(".yaml")]
    argv.remove("--d3net_config")
    with pytest.raises(ValueError, match="--d3net_config is required"):
        cli.main(argv)


ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script", ["train", "test"])
@pytest.mark.parametrize("model", list(FLAGS))
def test_recipe_shells_parse_to_the_jax_recipes_arguments(model, script):
    recipe = f"egs/musdb18/{model}/{script}.sh"
    module, argv = _recipe_argv(ROOT / "dnn_based_source_separation_torch" / recipe)
    jmodule, jargv = _recipe_argv(ROOT / recipe)
    name = "train_musdb18" if script == "train" else "test_musdb18"
    assert (module, jmodule) == (f"dnn_based_source_separation_torch.cli.{name}",
                                 f"dnn_based_source_separation_tpu.cli.{name}")
    for a in (argv, jargv):  # a choice flag: the shells' default value for its variable
        if "--conditioning" in a:
            a[a.index("--conditioning") + 1] = "film"
    parsers = (cli, jcli) if script == "train" else (test_cli, jtest_cli)
    args, jargs = (p.build_parser().parse_args(a) for p, a in zip(parsers, (argv, jargv)))
    assert args.device == "device" and "--device" not in jargv
    for field, value in vars(jargs).items():
        assert getattr(args, field) == value, field
