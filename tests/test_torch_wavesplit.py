"""The port's Wavesplit against the JAX package's, and its training CLI (CPU).

Tiny configs (D = 8, 3 speaker layers, 1 x 2 separation layers), inputs from numpy with
a seed, JAX weights carried across by `hub/from_jax.py:wavesplit_state_dict_from_jax`
(gLN / cLN gamma and beta scrambled away from identity), the JAX side under `jax.jit`,
each value held at TOL x max|ref| in f32:
- `speaker_distance_loss` and its sorted indices at 2 and 3 sources (at 3 the inverse
  permutation differs from the winning one), `entropy_regularization_loss` and its
  gradient;
- WaveSplit's oracle path with `return_all_layers` and `return_spk_vector`, causal or
  not; the KMeans path given JAX's initial centroids (`_kmeans_pp_init` on the port's
  speaker vectors, through `KMeans._init`);
- the loss and every gradient of a training step (per-layer negative SDR + speaker loss +
  entropy term), `spk_embedding`'s included;
- the speaker datasets and table against JAX's, and `cli/train_wsj0mix_wavesplit.py` on
  a corpus with wsj0-style IDs: it trains, resumes, and its checkpoint evaluates through
  `cli/test_wsj0mix.py` (the plain Tester, the KMeans path).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dnn_based_source_separation_torch.algorithm import clustering as tcl
from dnn_based_source_separation_torch.cli import test_wsj0mix as ttest
from dnn_based_source_separation_torch.cli import train_wsj0mix_wavesplit as ttrain
from dnn_based_source_separation_torch.criterion import NegSDR
from dnn_based_source_separation_torch.data import wsj0mix as twsj
from dnn_based_source_separation_torch.hub import wavesplit_state_dict_from_jax
from dnn_based_source_separation_torch.models.base import load_model
from dnn_based_source_separation_torch.models.wavesplit import (
    WaveSplit, entropy_regularization_loss, speaker_distance_loss,
)
from dnn_based_source_separation_torch.train.wavesplit import WaveSplitTrainer
from dnn_based_source_separation_tpu.algorithm.clustering import KMeans as JKMeans
from dnn_based_source_separation_tpu.criterion import NegSDR as JNegSDR
from dnn_based_source_separation_tpu.data import wsj0mix as jwsj
from dnn_based_source_separation_tpu.data.audio_io import write_wav
from dnn_based_source_separation_tpu.models import wavesplit as jws

TOL = 1e-4
CFG = dict(latent_dim=8, spk_num_layers=3, sep_num_blocks=1, sep_num_layers=2,
           n_training_sources=6, n_sources=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), np.abs(got - ref).max()


def _models(config, seed=1, T=200):
    jmodel = jws.WaveSplit(**config)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 1, T))))
    rng = np.random.default_rng(seed)
    for path, leaf in jax.tree_util.tree_flatten_with_path(variables["params"])[0]:
        parent = variables["params"]
        for p in path[:-1]:
            parent = parent[p.key]
        if path[-1].key in ("gamma", "beta"):  # non-identity norms, so they matter
            parent[path[-1].key] = (0.5 + rng.random(leaf.shape)).astype(np.float32)
    port = WaveSplit(**config)
    port.load_state_dict(wavesplit_state_dict_from_jax(variables, config))
    return jmodel, variables, port


def _inputs(B=2, T=200, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, 1, T)).astype(np.float32)


def _jax_init(data, seed=0, n_clusters=2):
    """JAX's kmeans++ draw (PRNGKey(seed)) on the port's data, for `KMeans._init`."""
    drawn = JKMeans(n_clusters, seed=seed)._init(jax.random.PRNGKey(seed),
                                                 jnp.asarray(data.detach().numpy()))
    return torch.from_numpy(np.array(drawn))


@pytest.mark.parametrize("S", [2, 3])
def test_speaker_distance_loss_and_sorted_indices_match_jax(S):
    rng = np.random.default_rng(S)
    B, T, D, n_train = 2, 30, 8, 7
    v = rng.standard_normal((B, T, S, D)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    table = rng.standard_normal((n_train, D)).astype(np.float32)
    spk_idx = np.stack([rng.permutation(n_train)[:S] for _ in range(B)])
    emb = table[spk_idx]
    loss, idx = jax.jit(jws.speaker_distance_loss)(v, emb, table, spk_idx)
    got_loss, got_idx = speaker_distance_loss(*(torch.from_numpy(a) for a in (v, emb, table,
                                                                              spk_idx)))
    _close(got_loss, loss)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    if S == 3:  # a 3-cycle won somewhere: there the inverse is not the winning permutation
        perms = {tuple(p) for p in got_idx.reshape(-1, S).tolist()}
        assert any(p != tuple(np.argsort(p)) for p in perms)


def test_entropy_regularization_loss_and_gradient_match_jax():
    table = np.random.default_rng(4).standard_normal((6, 8)).astype(np.float32)
    loss, grad = jax.jit(jax.value_and_grad(jws.entropy_regularization_loss))(table)
    t = torch.from_numpy(table).requires_grad_()
    got = entropy_regularization_loss(t)
    got.backward()
    _close(got, loss)
    _close(t.grad, grad)


@pytest.mark.parametrize("causal", [False, True])
def test_oracle_path_matches_jax(causal):
    config = dict(CFG, causal=causal)
    jmodel, variables, port = _models(config)
    x = _inputs()
    rng = np.random.default_rng(3)
    first = rng.integers(0, 2, (2, 200, 1))
    idx = np.concatenate([first, 1 - first], axis=-1)
    est, sorted_v = jax.jit(lambda v, x, i: jmodel.apply(
        v, x, i, return_all_layers=True, return_spk_vector=True))(variables, x, idx)
    got, got_v = port(torch.from_numpy(x), torch.from_numpy(idx), return_all_layers=True,
                      return_spk_vector=True)
    assert got.shape == (2, 2, 2, 200)  # (B, layers, sources, T)
    _close(got, est)
    _close(got_v, sorted_v)
    # without return_all_layers: the last layer's estimates
    torch.testing.assert_close(port(torch.from_numpy(x), torch.from_numpy(idx)), got[:, -1])


def test_kmeans_path_matches_jax_given_its_initial_centroids(monkeypatch):
    jmodel, variables, port = _models(CFG)
    x = _inputs(seed=5)
    expected = jax.jit(jmodel.apply)(variables, x)
    monkeypatch.setattr(tcl.KMeans, "_init", lambda self, data: _jax_init(data))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _close(got, expected)


def test_train_step_loss_and_gradients_match_jax():
    jmodel, variables, port = _models(CFG)
    x, spk_idx = _inputs(seed=6), np.array([[0, 1], [2, 5]], np.int32)
    sources = np.random.default_rng(7).standard_normal((2, 2, 200)).astype(np.float32)

    def loss_fn(p):  # JAX train/wavesplit.py:49-59, entropy_reg on
        est_all, spk_loss = jmodel.apply({"params": p}, x, spk_idx, method="forward_train")
        rec = JNegSDR()(est_all, jnp.asarray(sources)[:, None])
        return rec + jnp.mean(spk_loss) + jws.entropy_regularization_loss(p["spk_embedding"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    est_all, spk_loss = port.forward_train(torch.from_numpy(x), torch.from_numpy(spk_idx))
    got = (NegSDR()(est_all, torch.from_numpy(sources)[:, None]) + spk_loss.mean()
           + entropy_regularization_loss(port.spk_embedding))
    got.backward()
    _close(got, loss)
    ref = wavesplit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads), CFG)
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        _close(p.grad, ref[name])
    assert float(port.spk_embedding.grad.abs().max()) > 0


# -- datasets and the CLI ---------------------------------------------------------

SPEAKERS = ["011", "022", "205", "406"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """wsj0-style IDs (`<spkA utt>_<gain>_<spkB utt>_<gain>`), 3 train and 2 valid mixtures."""
    root = tmp_path_factory.mktemp("wsj0ws")
    rng = np.random.default_rng(0)
    pairs = {"tr": [(0, 1), (2, 3), (1, 2)], "cv": [(0, 3), (1, 3)]}
    for split, mixes in pairs.items():
        for sub in ("mix", "s1", "s2"):
            os.makedirs(root / split / sub)
        utts = []
        for i, (a, b) in enumerate(mixes):
            utt = f"{SPEAKERS[a]}a010{i}_1.2_{SPEAKERS[b]}c020{i}_-1.2"
            s1, s2 = 0.1 * rng.standard_normal(3200), 0.1 * rng.standard_normal(3200)
            write_wav(str(root / split / "s1" / f"{utt}.wav"), s1, 8000)
            write_wav(str(root / split / "s2" / f"{utt}.wav"), s2, 8000)
            write_wav(str(root / split / "mix" / f"{utt}.wav"), s1 + s2, 8000)
            utts.append(utt)
        (root / f"{split}.lst").write_text("\n".join(utts))
    return root


def test_speaker_datasets_match_jax(corpus):
    lst = str(corpus / "tr.lst")
    table, jtable = twsj.create_spk_to_idx(lst, 2), jwsj.create_spk_to_idx(lst, 2)
    assert table.speakers == jtable.speakers == SPEAKERS
    for utt in ("103-1240-0000_2002-139-0042", "011a0101_0.9_20cc0203_-0.9", "a_b"):
        assert twsj.speaker_keys(utt, 2) == jwsj.speaker_keys(utt, 2)
    with pytest.raises(ValueError):
        twsj.speaker_keys("tr00001", 2)
    ds = twsj.WaveTrainSpeakerDataset(str(corpus / "tr"), lst, samples=1600)
    jds = jwsj.WaveTrainSpeakerDataset(str(corpus / "tr"), lst, samples=1600)
    assert len(ds) == len(jds) == 9
    for i in range(len(ds)):
        for a, b in zip(ds[i], jds[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _args(corpus, exp, *extra):
    return ["--train_wav_root", str(corpus / "tr"), "--train_list_path", str(corpus / "tr.lst"),
            "--valid_wav_root", str(corpus / "cv"), "--valid_list_path", str(corpus / "cv.lst"),
            "--duration", "0.2", "--valid_duration", "0.3", "--batch_size", "3",
            "-D", "8", "--spk_num_layers", "2", "--sep_num_blocks", "1", "--sep_num_layers", "2",
            "--exp_dir", str(exp), "--device", "cpu", *extra]


def test_cli_trains_resumes_and_evaluates(corpus, tmp_path):
    exp = tmp_path / "exp"
    trainer = ttrain.main(_args(corpus, exp, "--epochs", "2", "--reg_criterion", "entropy"))
    assert isinstance(trainer, WaveSplitTrainer)
    assert trainer.model.spk_embedding.shape == (4, 8)  # the table's 4 speakers
    assert len(trainer.train_loss) == 2 and all(np.isfinite(trainer.train_loss
                                                             + trainer.valid_loss))
    last = exp / "model" / "last.ckpt"
    resumed = ttrain.main(_args(corpus, exp, "--epochs", "3", "--continue_from", str(last)))
    assert resumed.start_epoch == 2 and resumed.train_loss[:2] == trainer.train_loss
    model = load_model(str(last))
    assert isinstance(model, WaveSplit) and model.n_training_sources == 4
    result = ttest.main(["--test_wav_root", str(corpus / "cv"), "--test_list_path",
                         str(corpus / "cv.lst"), "--model_path", str(last), "--device", "cpu"])
    for key in ("loss", "loss_improvement", "sdr_improvement", "sir_improvement", "sar"):
        assert np.isfinite(result[key]), (key, result)


def test_cli_refusals(corpus, tmp_path):
    with pytest.raises(NotImplementedError, match="n_devices"):
        ttrain.main(_args(corpus, tmp_path, "--n_devices", "1"))
    if not torch.cuda.is_available():
        args = _args(corpus, tmp_path)
        args[args.index("--device") + 1] = "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrain.main(args)
