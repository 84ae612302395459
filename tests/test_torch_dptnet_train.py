"""DPTNet training in the port (CPU): the warmup schedule against optax's, the CLI round trip.

- `train/steps.py:make_warmup_optimizer` against the JAX package's (optax):
  the learning rate of update i at i = 0, w - 1, w, w + 1 and across epoch
  boundaries within 1e-6 relative (optax's update over optax.adam's at a
  learning rate of 1 under the same gradients), three
  clipped Adam steps within 1e-6, the Trainer's halving left alone, and the
  update count carried through `state_dict`;
- `cli/train_wsj0mix.py --model dptnet --warmup_steps 2` on a synthetic
  corpus, resumed, then its checkpoint through `cli/separate.py` (offline and
  `--chunk_duration`) and `cli/test_wsj0mix.py`, and opened in JAX.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.cli import test_wsj0mix as ttest
from dnn_based_source_separation_torch.cli import train_wsj0mix as ttrain
from dnn_based_source_separation_torch.models import DPTNet
from dnn_based_source_separation_torch.models.base import load_model, read_checkpoint
from dnn_based_source_separation_torch.train import (
    WarmupOptimizer, get_learning_rate, make_warmup_optimizer, set_learning_rate,
)
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.hub.torch_convert import build_from_torch_checkpoint
from dnn_based_source_separation_tpu.train.steps import (
    make_warmup_optimizer as jax_make_warmup_optimizer,
)

K1, K2, D_MODEL = 0.2, 4e-4, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _optax_rates(warmup, steps_per_epoch, n):
    """optax's learning rate at updates 0..n-1: its update over that of optax.adam at a
    learning rate of 1 under the same gradients (the same direction, one f32 product apart)."""
    scheduled = jax_make_warmup_optimizer(K1, K2, D_MODEL, warmup, steps_per_epoch)
    unit = optax.adam(1.0)
    params = jnp.zeros(())
    states = [scheduled.init(params), unit.init(params)]
    rates = []
    for _ in range(n):
        (u_s, states[0]), (u_1, states[1]) = (opt.update(jnp.ones(()), state, params)
                                              for opt, state in zip((scheduled, unit), states))
        rates.append(float(u_s) / float(u_1))
    return rates


@pytest.mark.parametrize("warmup,steps_per_epoch", [(4, 3), (6, 2), (5, 5)])
def test_schedule_matches_optax(warmup, steps_per_epoch):
    n = warmup + 3 * steps_per_epoch + 2
    expected = _optax_rates(warmup, steps_per_epoch, n)
    opt = make_warmup_optimizer(K1, K2, D_MODEL, warmup, steps_per_epoch,
                                params=[torch.nn.Parameter(torch.zeros(()))])
    # i = 0, w - 1, w, w + 1 (the strict comparison) and every epoch boundary past them.
    checked = {0, warmup - 1, warmup, warmup + 1,
               *range(0, n, steps_per_epoch), *range(steps_per_epoch - 1, n, steps_per_epoch)}
    for i in sorted(checked):
        assert opt.schedule(i) == pytest.approx(expected[i], rel=1e-6), i
    ramp_end = K1 * D_MODEL ** -0.5 * (warmup + 1) * warmup ** -1.5
    assert opt.schedule(warmup) == pytest.approx(ramp_end)
    assert opt.schedule(warmup + 1) == K2 * 0.98 ** (((warmup + 1) // steps_per_epoch + 1) // 2)


def test_three_clipped_adam_steps_match_optax():
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # Global norms about 2, 11 and 3: below, above and below max_norm = 5.
    grads = [[scale * rng.standard_normal(s).astype(np.float32) / 3 for s in shapes]
             for scale in (1.0, 6.0, 1.5)]
    # warmup 1, one update an epoch: updates 0 and 1 ramp, update 2 decays.
    jopt = jax_make_warmup_optimizer(K1, K2, D_MODEL, 1, 1, max_norm=5.0)
    j_params = [jnp.asarray(a) for a in init]
    state = jopt.init(j_params)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    port = make_warmup_optimizer(K1, K2, D_MODEL, 1, 1, max_norm=5.0, params=params)
    for g in grads:
        updates, state = jopt.update([jnp.asarray(a) for a in g], state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        port.zero_grad()
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        port.step()
        for p, j in zip(params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)
    assert port.count == 3


def test_halving_leaves_the_schedule_alone_and_the_count_resumes():
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = make_warmup_optimizer(K1, K2, D_MODEL, 4, 2, params=params)
    for _ in range(3):
        params[0].grad = torch.ones(3)
        opt.step()
    assert np.isnan(get_learning_rate(opt))
    assert set_learning_rate(opt, 123.0) is opt
    assert opt.param_groups[0]["lr"] == opt.schedule(2)
    state = opt.state_dict()
    assert state["schedule_count"] == 3
    again = make_warmup_optimizer(K1, K2, D_MODEL, 4, 2, params=params)
    again.load_state_dict(state)
    assert isinstance(again, WarmupOptimizer) and again.count == 3
    torch.testing.assert_close(again.inner.state_dict()["state"][0]["exp_avg"],
                               opt.inner.state_dict()["state"][0]["exp_avg"])


# -- the CLI round trip --------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wsj0")
    rng = np.random.default_rng(0)
    for split, n_utts in (("tr", 3), ("cv", 2)):  # 4 train steps an epoch: n - 1 > warmup
        for sub in ("mix", "s1", "s2"):
            os.makedirs(root / split / sub)
        utts = []
        for i in range(n_utts):
            s1, s2 = 0.1 * rng.standard_normal(4000), 0.1 * rng.standard_normal(4000)
            utt = f"{split}{i}"
            write_wav(str(root / split / "s1" / f"{utt}.wav"), s1, 8000)
            write_wav(str(root / split / "s2" / f"{utt}.wav"), s2, 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), s1 + s2, 8000)
            utts.append(utt)
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


MODEL_ARGS = ["--model", "dptnet", "-N", "16", "-L", "4", "-H", "8", "-B", "8", "-K", "10",
              "-R", "2", "--sep_num_heads", "2", "--mask_nonlinear", "relu",
              "--warmup_steps", "2"]


def _args(corpus, exp, *extra):
    return ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--duration", "0.25", "--valid_duration", "0.5", "--batch_size", "2",
            "--exp_dir", str(exp), "--device", "cpu", *MODEL_ARGS, *extra]


@pytest.mark.parametrize("causal", ["0", "1"])
def test_cli_trains_resumes_serves_and_evaluates_dptnet(corpus, tmp_path, causal):
    exp = tmp_path / "exp"
    trainer = ttrain.main(_args(corpus, exp, "--epochs", "2", "--causal", causal))
    assert isinstance(trainer.model, DPTNet) and trainer.model.causal == bool(int(causal))
    assert isinstance(trainer.optimizer, WarmupOptimizer)
    assert all(np.isfinite(trainer.train_loss + trainer.valid_loss))
    # The schedule's epoch is the train loader's length (JAX's steps_per_epoch).
    n = len(trainer.train_loader)
    assert n > 2 and trainer.optimizer.count == 2 * n
    assert trainer.optimizer.schedule(n - 1) == K2 and trainer.optimizer.schedule(n) == K2 * 0.98
    last = exp / "model" / "last.ckpt"
    extra = read_checkpoint(str(last))["extra"]
    assert extra["optim"]["schedule_count"] == 2 * n

    resumed = ttrain.main(_args(corpus, exp, "--epochs", "3", "--continue_from", str(last),
                                "--causal", causal))
    assert resumed.start_epoch == 2 and resumed.optimizer.count == 3 * n

    wav = str(corpus / "cv" / "mix" / "cv0.wav")
    for flags in ([], ["--chunk_duration", "0.2"]):
        est = tsep.main(["--model_path", str(last), "--input", wav, "--out_dir",
                         str(tmp_path / "sep"), "--device", "cpu", *flags])
        assert est.shape == (2, 4000) and np.isfinite(est).all()
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
