"""Port's training stack against the JAX package (CPU): optimizer, one train step, Trainer, CLI.

- The optimizer: the same numpy gradients fed to optax and to the port's
  `make_optimizer` agree within 1e-6 over 3 steps with clipping and an LR
  halving.
- The decoder runs its plain decode under autograd.
- The Trainer and the train CLI: epochs, checkpoints, resume, LR halving and
  early stop, serving and opening the trained checkpoint, refusals.
The one-step parity of whole models with JAX is in test_torch_train_step.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dnn_based_source_separation_torch.cli import separate as tsep
from dnn_based_source_separation_torch.cli import train_wsj0mix as ttrain
from dnn_based_source_separation_torch.cli.model_factory import build_wsj0mix_model
from dnn_based_source_separation_torch.models import ConvTasNet
from dnn_based_source_separation_torch.models.base import load_model, read_checkpoint
from dnn_based_source_separation_torch.models.streaming import ExactStreamingSeparator
from dnn_based_source_separation_torch.ops import filterbank as tfb
from dnn_based_source_separation_torch.train import (
    OptaxRMSprop, Trainer, TrainerConfig, get_learning_rate, make_optimizer, set_learning_rate,
)
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.hub.torch_convert import build_from_torch_checkpoint
from dnn_based_source_separation_tpu.train.steps import set_learning_rate as jax_set_learning_rate

CONV = dict(n_basis=16, kernel_size=8, stride=4, enc_nonlinear="relu", sep_num_blocks=2,
            sep_num_layers=3, sep_hidden_channels=20, sep_bottleneck_channels=12,
            sep_skip_channels=12, causal=False, n_sources=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- optimizer -------------------------------------------------------------

def _optax(name, lr, max_norm):
    inner = {"adam": lambda: optax.inject_hyperparams(optax.adam)(learning_rate=lr),
             "sgd": lambda: optax.inject_hyperparams(optax.sgd)(learning_rate=lr),
             "momentum-sgd": lambda: optax.inject_hyperparams(optax.sgd)(learning_rate=lr,
                                                                        momentum=0.9)}[name]()
    return optax.chain(optax.clip_by_global_norm(max_norm), inner)


@pytest.mark.parametrize("name", ["adam", "sgd", "momentum-sgd"])
def test_optimizer_matches_optax(name):
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # Global norms about 2, 11 and 3: below, above and below max_norm = 5.
    grads = [[scale * rng.standard_normal(s).astype(np.float32) / 3 for s in shapes]
             for scale in (1.0, 6.0, 1.5)]
    opt = _optax(name, 1e-3, 5.0)
    j_params = [jnp.asarray(a) for a in init]
    state = opt.init(j_params)
    params = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    port = make_optimizer(name, 1e-3, 5.0, params=params)
    for step, g in enumerate(grads):
        if step == 2:  # the Trainer's LR halving, between steps 2 and 3
            state = jax_set_learning_rate(state, 5e-4)
            set_learning_rate(port, 5e-4)
            assert get_learning_rate(port) == 5e-4
        updates, state = opt.update([jnp.asarray(a) for a in g], state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        port.zero_grad()
        for p, a in zip(params, g):
            p.grad = torch.from_numpy(a.copy())
        port.step()
        for p, j in zip(params, j_params):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_clipping_is_optax_not_torch():
    # At norm = max_norm optax leaves the gradient alone, and clip_grad_norm_
    # scales it by max_norm / (norm + 1e-6).
    g = np.full((4,), 2.5, np.float32)  # norm 5.0
    p = torch.nn.Parameter(torch.zeros(4))
    port = make_optimizer("sgd", 1.0, 5.0, params=[p])
    p.grad = torch.from_numpy(g.copy())
    port.step()
    np.testing.assert_array_equal(p.detach().numpy(), -g)


def test_rmsprop_and_unknown_optimizers_raise():
    # 'rmsprop' builds optax's rule now (tests/test_torch_attractor.py holds it to optax);
    # an optimizer the JAX factory does not know still raises.
    p = [torch.nn.Parameter(torch.zeros(2))]
    assert isinstance(make_optimizer("rmsprop", 1e-3, params=p).inner, OptaxRMSprop)
    with pytest.raises(ValueError):
        make_optimizer("adagrad", 1e-3, params=p)


# -- decoder under autograd ----------------------------------------------------

def test_decoder_runs_the_plain_decode_under_autograd(monkeypatch):
    calls = []
    kernel_wrapper = tfb.fused_mask_decode

    def counting(*args):
        calls.append(1)
        return kernel_wrapper(*args)

    monkeypatch.setattr(tfb, "fused_mask_decode", counting)
    decoder = tfb.ConvDecoder(16, 8, 4, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((2, 30, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.uniform(0, 1, (2, 30, 2, 16)).astype(np.float32)).transpose(1, 2)
    with torch.no_grad():
        served = decoder(w, mask)
    assert len(calls) == 1
    w_, mask_ = w.clone().requires_grad_(), mask.clone().requires_grad_()
    trained = decoder(w_, mask_)
    assert len(calls) == 1  # no kernel call while recording
    torch.testing.assert_close(trained, served, rtol=0, atol=0)
    trained.square().sum().backward()
    # The same function: its gradient against an independent autograd of the formula.
    w2, m2 = w.clone().requires_grad_(), mask.clone().requires_grad_()
    k = decoder.conv_transpose1d.weight.detach().reshape(16, -1)
    frames = (w2[:, None] * m2) @ k
    from dnn_based_source_separation_torch.ops.filterbank import unfold_apply

    unfold_apply(frames.reshape(2, 2, 30, 1, 8).movedim(-2, -3), 4).square().sum().backward()
    torch.testing.assert_close(w_.grad, w2.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mask_.grad, m2.grad, rtol=1e-5, atol=1e-6)


# -- Trainer and CLI -------------------------------------------------------------

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


CLI_MODELS = {
    "conv-tasnet": ["--model", "conv-tasnet", "-N", "16", "-L", "8", "-H", "16", "-B", "8",
                    "-Sc", "8", "-R", "1", "-X", "2"],
    "dprnn-tasnet": ["--model", "dprnn-tasnet", "-N", "16", "-L", "4", "-H", "12", "-B", "8",
                     "-K", "10", "--sep_hop_size", "5", "-R", "2"],
}


def _train_resume_serve(corpus, tmp_path, model_args):
    exp = tmp_path / "exp"
    trainer = ttrain.main(_args(corpus, exp, "--epochs", "2", *model_args))
    assert len(trainer.train_loss) == len(trainer.valid_loss) == 2
    assert all(np.isfinite(trainer.train_loss + trainer.valid_loss))
    last = exp / "model" / "last.ckpt"
    assert last.exists() and (exp / "model" / "best.ckpt").exists()
    assert sorted(os.listdir(exp / "sample")) == ["0", "1", "2"]

    # Resume: the saved optimizer state and counters come back, and training goes on.
    extra = read_checkpoint(str(last))["extra"]
    assert extra["epoch"] == 1 and extra["train_loss"] == trainer.train_loss
    resumed = ttrain.main(_args(corpus, exp, "--epochs", "3", "--continue_from", str(last),
                                *model_args))
    assert resumed.start_epoch == 2
    assert resumed.train_loss[:2] == trainer.train_loss and len(resumed.train_loss) == 3
    saved = extra["optim"]["state"]
    restored = make_optimizer("adam", 1e-3, params=load_model(str(last)).parameters())
    restored.load_state_dict(extra["optim"])
    for i, s in saved.items():
        torch.testing.assert_close(restored.state_dict()["state"][i]["exp_avg"], s["exp_avg"])

    # The trained checkpoint serves through the port's CLI.
    wav = str(corpus / "cv" / "mix" / "cv0.wav")
    est = tsep.main(["--model_path", str(last), "--input", wav, "--out_dir",
                     str(tmp_path / "sep"), "--device", "cpu"])
    assert est.shape == (2, 4000) and np.isfinite(est).all()
    return trainer


@pytest.mark.parametrize("model", list(CLI_MODELS))
def test_cli_trains_resumes_and_serves(corpus, tmp_path, model, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    _train_resume_serve(corpus, tmp_path, CLI_MODELS[model])
    # The train and serve CLIs turned TF32 off (utils/device.py).
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


def test_cli_trains_resumes_and_serves_a_gru_dprnn_tasnet(corpus, tmp_path):
    model_args = [*CLI_MODELS["dprnn-tasnet"], "--rnn_type", "gru"]
    trainer = _train_resume_serve(corpus, tmp_path, model_args)
    assert type(trainer.model.separator.dprnn.net[0].intra_chunk_block.rnn).__name__ == "GRU"
    # Every parameter trained away from the seed's initial model, both biases
    # of every GRU chain included (JAX trains both; only the LSTM freezes one).
    initial = build_wsj0mix_model(
        ttrain.build_parser().parse_args(_args(corpus, tmp_path, *model_args)), "cpu")
    trained = dict(trainer.model.named_parameters())
    assert any(".bias_hh_l0" in name for name in trained)
    for name, p in initial.named_parameters():
        assert not torch.equal(p, trained[name]), name


@pytest.mark.parametrize("model", list(CLI_MODELS))
def test_trained_checkpoint_opens_in_jax(corpus, tmp_path, model):
    exp = tmp_path / "exp"
    ttrain.main(_args(corpus, exp, "--epochs", "1", *CLI_MODELS[model]))
    path = str(exp / "model" / "last.ckpt")
    jmodel, jparams = build_from_torch_checkpoint(path)
    port = load_model(path)
    x = np.random.default_rng(0).standard_normal((1, 1, 400)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jmodel.apply)(jparams, jnp.asarray(x))),
                               rtol=0, atol=1e-4)


class _StubTrainer(Trainer):
    """Training epochs cost nothing and validation losses come from a list."""

    def __init__(self, valid_losses, **kwargs):
        super().__init__(**kwargs)
        self._valid = iter(valid_losses)

    def run_one_epoch_train(self, epoch):
        return 0.0

    def run_one_epoch_eval(self, epoch):
        return next(self._valid)


def test_lr_halving_and_early_stop_follow_the_jax_trainer(tmp_path, capsys):
    # trainer.py:138-158: a new best resets the count; a loss >= the previous
    # one adds one; from 3 on each such epoch halves the LR; at 10 it stops.
    model = ConvTasNet(**CONV)
    optimizer = make_optimizer("adam", 1e-3, params=model.parameters())
    losses = [5.0, 4.0, 4.5, 4.2, 4.1, 4.1, 4.1, 4.2, 4.3, 4.4, 4.5, 4.6, 4.7, 4.8, 9.0]
    trainer = _StubTrainer(losses, model=model, train_loader=[], valid_loader=[],
                           criterion=None, optimizer=optimizer,
                           config=TrainerConfig(epochs=30, exp_dir=str(tmp_path)), device="cpu")
    trainer.run()
    # Epoch 3 (4.5 >= 4.0) counts 1; 4.2 < 4.5 and 4.1 < 4.2 reset it; then
    # 4.1 >= 4.1 counts 1, 4.1 again 2, and every later rise counts up to 10.
    assert trainer.valid_loss == losses
    assert trainer.no_improvement == 10
    out = capsys.readouterr().out
    assert out.count("Learning rate:") == 7 and "Stop training" in out
    assert get_learning_rate(optimizer) == pytest.approx(1e-3 / 2 ** 7)
    assert trainer.best_loss == 4.0


@pytest.mark.parametrize("flag", [["--device_resident_data", "1"], ["--n_devices", "1"]])
def test_unported_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(NotImplementedError):
        ttrain.main(_args(corpus, tmp_path, *CLI_MODELS["dprnn-tasnet"], *flag))


def test_sru_and_unported_models_raise(corpus, tmp_path):
    # --rnn_type sru and --model furcanet train now (tests/test_torch_rnn_sru.py,
    # tests/test_torch_furcanet.py); what still raises: exact streaming of an SRU
    # model, whose JAX counterpart ignores the carried state, and a model the JAX
    # factory does not build. The causal SRU model is the one the CLI's factory builds
    # from these flags (training it first changes nothing the refusal reads).
    args = ttrain.build_parser().parse_args(_args(corpus, tmp_path, *CLI_MODELS["dprnn-tasnet"],
                                                  "--rnn_type", "sru", "--causal", "1"))
    args.causal = bool(args.causal)
    model = build_wsj0mix_model(args, "cpu")
    assert model.causal and type(model.separator.dprnn.net[0].intra_chunk_block.rnn).__name__ \
        == "SRU"
    with pytest.raises(NotImplementedError, match="sru"):
        ExactStreamingSeparator(model.eval(), hop_samples=16)
    with pytest.raises(ValueError, match="Unsupported model"):
        ttrain.main(_args(corpus, tmp_path, "--model", "tasnet-of-the-future"))


def test_cuda_without_a_card_raises(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = _args(corpus, tmp_path, *CLI_MODELS["conv-tasnet"])
    args[args.index("--device") + 1] = "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(args)
