"""ORPIT Conv-TasNet and the other PITs through the port's training stack (CPU).

- `WaveTrainVariableSourcesDataset` items bit for bit against JAX's on a corpus of 2- and
  3-speaker utterances;
- one `ORPITTrainer` train step of a tiny Conv-TasNet (N 16, L 8, B 8, H 16, Sc 8, R 1,
  X 2, relu encoder) against JAX's ORPIT loss function from the same weights
  (`hub/from_jax.py`): the loss within 1e-5 relative, every gradient within 1e-4 x max|g|
  of its tensor (f32);
- `cli/train_wsj0mix.py --device cpu` with `--criterion orpit --n_sources 3` and with each
  `--pit`: `last.ckpt` written, a finite loss; the ORPIT checkpoint evaluated through the
  port's `cli/test_wsj0mix.py`; the refusals that stay;
- the port's recipe shells (`egs/wsj0-mix/orpit_conv-tasnet`, `frequency-mask`) parse to the
  JAX recipes' arguments.
"""
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.cli import test_oracle_masks as oracle_cli
from dnn_based_source_separation_torch.cli import test_wsj0mix as test_cli
from dnn_based_source_separation_torch.cli import train_wsj0mix as cli
from dnn_based_source_separation_torch.criterion import ORPIT, NegSISDR
from dnn_based_source_separation_torch.data import DataLoader, WaveTrainVariableSourcesDataset
from dnn_based_source_separation_torch.hub import conv_tasnet_state_dict_from_jax
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.models.base import load_model
from dnn_based_source_separation_torch.train import ORPITTrainer, TrainerConfig, make_optimizer
from dnn_based_source_separation_tpu.cli import test_oracle_masks as joracle_cli
from dnn_based_source_separation_tpu.cli import test_wsj0mix as jtest_cli
from dnn_based_source_separation_tpu.cli import train_wsj0mix as jcli
from dnn_based_source_separation_tpu.criterion import ORPIT as JORPIT
from dnn_based_source_separation_tpu.criterion import NegSISDR as JNegSISDR
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.data.wsj0mix import (
    WaveTrainVariableSourcesDataset as JWaveTrainVariableSourcesDataset,
)
from dnn_based_source_separation_tpu.models import ConvTasNet as JConvTasNet
from test_torch_bench import _recipe_argv

CONV = dict(n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=1,
            sep_num_layers=2, sep_hidden_channels=16, sep_bottleneck_channels=8,
            sep_skip_channels=8, causal=False, n_sources=2)
CONV_FLAGS = ["-N", "16", "-L", "8", "-H", "16", "-B", "8", "-Sc", "8", "-R", "1", "-X", "2"]
ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tr / cv / tt splits of 2- and 3-speaker utterances (0.5 s, 8 kHz) written with the
    JAX package's `write_wav`; each split's list names both kinds."""
    root = tmp_path_factory.mktemp("wsj0_2and3")
    rng = np.random.default_rng(0)
    for split in ("tr", "cv", "tt"):
        for sub in ("mix", "s1", "s2", "s3"):
            os.makedirs(root / split / sub)
        utts = []
        for i, n in enumerate((2, 3, 3, 2)):
            srcs = 0.2 * rng.standard_normal((n, 4000))
            utt = f"{split}_{n}spk_{i}"
            for s in range(n):
                write_wav(str(root / split / f"s{s + 1}" / f"{utt}.wav"), srcs[s], 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), srcs.sum(axis=0), 8000)
            utts.append(utt)
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


def test_variable_sources_dataset_matches_jax(corpus):
    args = (str(corpus / "tr"), str(corpus / "tr.lst"))
    port = WaveTrainVariableSourcesDataset(*args, samples=1600, max_sources=3)
    ref = JWaveTrainVariableSourcesDataset(*args, samples=1600, max_sources=3)
    assert len(port) == len(ref) == 16  # four windows of each 0.5 s utterance
    counts = []
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        counts.append(int(got[2]))
        assert not got[1][got[2]:].any()  # zero beyond the count
    assert sorted(set(counts)) == [2, 3]
    batch = next(iter(DataLoader(port, batch_size=4)))
    assert batch[2].dtype == np.int32 and batch[2].shape == (4,)
    # an explicit count per utterance overrides the files
    fixed = WaveTrainVariableSourcesDataset(*args, samples=1600, max_sources=3,
                                            n_sources_per_utt={"tr_3spk_1": 2})
    assert int(fixed[4][2]) == 2 and not fixed[4][1][2].any()


def test_orpit_train_step_matches_jax(corpus, tmp_path):
    dataset = WaveTrainVariableSourcesDataset(str(corpus / "tr"), str(corpus / "tr.lst"),
                                              samples=1600, max_sources=3)
    mixture, sources, counts = (np.stack(f) for f in zip(*(dataset[i] for i in (0, 5, 9))))
    assert counts.tolist() == [2, 3, 3]
    jmodel = JConvTasNet(**CONV)
    variables = jax.tree_util.tree_map(
        np.asarray, jmodel.init(jax.random.PRNGKey(1), jnp.asarray(mixture[:1])))
    criterion = JORPIT(JNegSISDR())

    @jax.jit
    def loss_and_grads(params, mix, src, cnt):  # JAX's ORPITTrainer loss (trainer.py:343-347)
        return jax.value_and_grad(
            lambda p: criterion(jmodel.apply({"params": p}, mix), src, n_sources=cnt)[0])(params)

    j_loss, j_grads = loss_and_grads(variables["params"], mixture, sources, counts)
    j_grads = conv_tasnet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_grads), CONV)

    model = ConvTasNet(**CONV)
    model.load_state_dict(conv_tasnet_state_dict_from_jax(variables, CONV))
    optimizer = make_optimizer("sgd", 0.0, params=model.parameters())  # the weights stay
    trainer = ORPITTrainer(model, [], [], ORPIT(NegSISDR()), optimizer,
                           TrainerConfig(exp_dir=str(tmp_path)), "cpu")
    loss = float(trainer.train_step(*(torch.from_numpy(a) for a in (mixture, sources, counts))))
    assert abs(loss - float(j_loss)) <= 1e-5 * abs(float(j_loss)), (loss, float(j_loss))
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(j_grads)
    for k, g in j_grads.items():
        got, g = grads[k].grad.numpy(), g.numpy()
        assert np.abs(got - g).max() <= 1e-4 * np.abs(g).max(), k


def _train_argv(corpus, exp, *extra):
    return ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--model", "conv-tasnet", *CONV_FLAGS, "--duration", "0.25",
            "--valid_duration", "0.25", "--batch_size", "4", "--epochs", "1",
            "--exp_dir", str(exp), "--device", "cpu", *extra]


def test_orpit_cli_trains_and_its_checkpoint_evaluates(corpus, tmp_path):
    trainer = cli.main(_train_argv(corpus, tmp_path / "exp", "--criterion", "orpit",
                                   "--n_sources", "3"))
    assert isinstance(trainer, ORPITTrainer) and np.isfinite(trainer.train_loss[-1])
    assert np.isfinite(trainer.valid_loss[-1])
    ckpt = tmp_path / "exp" / "model" / "last.ckpt"
    model = load_model(str(ckpt))
    assert model.n_sources == 2  # the (one, rest) pair
    summary = test_cli.main(["--test_wav_root", str(corpus / "tt"), "--test_list_path",
                             str(corpus / "tt.lst"), "--model_path", str(ckpt),
                             "--filt_len", "16", "--device", "cpu"])
    assert np.isfinite(summary["loss"])


@pytest.mark.parametrize("pit", ["hungarian", "prob", "sink"])
def test_cli_trains_with_each_pit(corpus, tmp_path, pit):
    trainer = cli.main(_train_argv(corpus, tmp_path / "exp", "--pit", pit, "--pit_gamma", "0.5"))
    assert os.path.exists(tmp_path / "exp" / "model" / "last.ckpt")
    assert np.isfinite(trainer.train_loss[-1]) and np.isfinite(trainer.valid_loss[-1])
    criterion = cli._pit_criterion(cli.build_parser().parse_args(
        _train_argv(corpus, tmp_path, "--pit", pit, "--pit_gamma", "0.5")))
    assert type(criterion).__name__ == {"hungarian": "HungarianLoss", "prob": "ProbPIT",
                                        "sink": "SinkPIT"}[pit]
    assert getattr(criterion, "gamma", 0.5) == 0.5


@pytest.mark.parametrize("script", ["orpit_conv-tasnet/train.sh", "orpit_conv-tasnet/test.sh",
                                    "frequency-mask/test.sh"])
def test_recipe_shells_parse_to_the_jax_recipes_arguments(script):
    recipe = f"egs/wsj0-mix/{script}"
    module, argv = _recipe_argv(ROOT / "dnn_based_source_separation_torch" / recipe)
    jmodule, jargv = _recipe_argv(ROOT / recipe)
    name = {"train.sh": "train_wsj0mix", "test.sh": "test_wsj0mix"}[script.split("/")[1]]
    if script.startswith("frequency-mask"):
        name = "test_oracle_masks"
        for a in (argv, jargv):  # a choice flag: the shells' default value for its variable
            a[a.index("--mask") + 1] = "ibm"
    assert (module, jmodule) == (f"dnn_based_source_separation_torch.cli.{name}",
                                 f"dnn_based_source_separation_tpu.cli.{name}")
    parsers = {"train_wsj0mix": (cli, jcli), "test_wsj0mix": (test_cli, jtest_cli),
               "test_oracle_masks": (oracle_cli, joracle_cli)}[name]
    args, jargs = (p.build_parser().parse_args(a) for p, a in zip(parsers, (argv, jargv)))
    assert args.device == "device" and "--device" not in jargv
    for field, value in vars(jargs).items():
        assert getattr(args, field) == value, field
    if name == "train_wsj0mix":  # the paper width, ORPIT over at most --n_sources speakers
        assert (args.criterion, args.n_sources, args.n_basis, args.sep_num_layers) == \
            ("orpit", 2, 512, 8)
