"""The port's bench module, entry module and recipe shells (CPU).

The bench's FLOP count from the config against `torch.utils.flop_counter`
on the plain path (matmul and conv terms; the depthwise taps are
elementwise there and are checked from the config alone); its JSON lines
with `--device cpu`; its refusal to time a card that is not there; and the
command line of each of the port's recipe shells, parsed by the port's own
CLI parser.
"""
import json
import pathlib
import re
import shlex

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dnn_based_source_separation_torch import bench
from dnn_based_source_separation_torch.cli import test_musdb18, test_wsj0mix, train_wsj0mix
from dnn_based_source_separation_torch.entry import TINY, entry, flagship
from dnn_based_source_separation_torch.models import DPRNNTasNet, DPTNet

RECIPES = pathlib.Path(bench.__file__).resolve().parent / "egs" / "wsj0-mix"
MUSDB_RECIPES = RECIPES.parent / "musdb18"
DPRNN_TINY = dict(bench.DPRNN, n_basis=16, kernel_size=4, stride=2, sep_bottleneck_channels=8,
                  sep_hidden_channels=8, sep_chunk_size=10, sep_hop_size=5, sep_num_blocks=2)
DPTNET_TINY = dict(bench.DPTNET, n_basis=16, kernel_size=4, stride=2, sep_bottleneck_channels=8,
                   sep_hidden_channels=8, sep_chunk_size=10, sep_num_blocks=2, sep_num_heads=2)
TINY_RUN = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench at tiny widths on 0.25 s mixtures."""
    monkeypatch.setattr(bench, "SECONDS", 0.25)
    monkeypatch.setattr(bench, "CONFIGS", {"conv-tasnet": TINY, "dprnn-tasnet": DPRNN_TINY,
                                           "dptnet": DPTNET_TINY})


@pytest.fixture
def tiny_musdb_bench(monkeypatch):
    """The musdb18 bench at tiny widths: 0.5 s at 8 kHz in 0.2 s chunks, one timed track."""
    monkeypatch.setattr(bench, "MUSDB_SAMPLE_RATE", 8000)
    monkeypatch.setattr(bench, "MUSDB_SECONDS", 0.5)
    monkeypatch.setattr(bench, "MUSDB_CHUNK", 0.2)
    monkeypatch.setattr(bench, "MUSDB_TRACKS", 1)
    monkeypatch.setattr(bench, "UMX_STFT", dict(n_fft=64, hop_length=16, window_fn="hann"))
    monkeypatch.setattr(bench, "UMX", dict(in_channels=2, hidden_channels=16, num_layers=2,
                                           n_bins=33, max_bin=20))


def _counted(model, T, batch=1):
    x = torch.randn(batch, 1, T)
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model(x)
    return counter.get_total_flops()


@pytest.mark.parametrize("T", [1000, 1003])
@pytest.mark.parametrize("variant", [dict(), dict(causal=True), dict(separable=False)],
                         ids=["flagship", "causal", "non-separable"])
def test_conv_tasnet_flops_match_the_flop_counter(T, variant):
    model = flagship(True, device="cpu", generator=torch.Generator().manual_seed(0), **variant)
    flops = bench.forward_flops(model, T, batch=2)
    assert flops["matmul"] == _counted(model, T, batch=2)
    config = model.get_config()
    layers = config["sep_num_blocks"] * config["sep_num_layers"]
    frames = bench._frames(config, T)
    taps = layers * frames * config["sep_hidden_channels"] * config["sep_kernel_size"]
    assert flops["depthwise"] == (2 * 2 * taps if config.get("separable", True) else 0)


def test_paper_config_flops_from_the_config():
    # B=8 x 4 s: T' = 3999 frames. Multiply-adds a frame, by hand: encoder 16 x
    # 512, bottleneck 512 x 128, 24 layers of 128 x 512 in and 512 x (128 + 128)
    # heads less the last layer's output head, mask head 128 x 1024, decoder
    # 2 x 512 x 16; depthwise 24 x 512 x 3.
    model = flagship(device="meta")
    flops = bench.forward_flops(model, 32000, batch=8)
    assert bench._frames(model.get_config(), 32000) == 3999
    per_frame = (16 * 512 + 512 * 128 + 24 * (128 * 512 + 512 * 256) - 512 * 128
                 + 128 * 1024 + 2 * 512 * 16)
    assert flops == {"matmul": 2 * 8 * 3999 * per_frame,
                     "depthwise": 2 * 8 * 3999 * 24 * 512 * 3}


@pytest.mark.parametrize("rnn_type", ["lstm", "gru"])
@pytest.mark.parametrize("causal,stream_safe", [(False, False), (True, False), (True, True)])
def test_dprnn_tasnet_flops_match_the_flop_counter(rnn_type, causal, stream_safe):
    model = DPRNNTasNet(**dict(DPRNN_TINY, rnn_type=rnn_type, causal=causal,
                               stream_safe=stream_safe),
                        generator=torch.Generator().manual_seed(0)).eval()
    flops = bench.forward_flops(model, 203)
    assert flops == {"matmul": _counted(model, 203), "depthwise": 0}


@pytest.mark.parametrize("T", [203, 250])
@pytest.mark.parametrize("causal", [False, True])
def test_dptnet_flops_match_the_flop_counter(T, causal):
    model = DPTNet(**dict(DPTNET_TINY, causal=causal),
                   generator=torch.Generator().manual_seed(0)).eval()
    assert bench.forward_flops(model, T, batch=2) == {"matmul": _counted(model, T, batch=2),
                                                     "depthwise": 0}


def test_dptnet_recipe_flops_from_the_config():
    # B=8 x 4 s: T' = 31999 frames, padded by 1 to 32000 = 639 chunks of K = 100 at hop 50,
    # 63900 chunked positions. Multiply-adds a position of one improved transformer, by
    # hand (E = 64, H = 256): projections 4 x 64^2, attention 2 x 64 x L (L = 100 intra,
    # 639 inter), a bidirectional LSTM 2 x (1024 x 64 + 1024 x 256) and fc 512 x 64.
    model = DPTNet(**bench.DPTNET, device="meta")
    ffn = 2 * (1024 * 64 + 1024 * 256) + 512 * 64
    per_position = 2 * (4 * 64 * 64 + ffn) + 2 * 64 * (100 + 639)
    # encoder 2 x 64, bottleneck 64 x 64, map 64 x 128, GTU 2 x 2 x 64^2, decoder 2 x 64 x 2.
    per_frame = 2 * 64 + 64 * 64 + 64 * 128 + 4 * 64 * 64 + 2 * 64 * 2
    assert bench.forward_flops(model, 32000, batch=8) == {
        "matmul": 2 * 8 * (31999 * per_frame + 6 * 63900 * per_position), "depthwise": 0}


def test_offline_json_line(tiny_bench, capsys, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)  # PyTorch's default
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    result = bench.main(TINY_RUN)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    out = capsys.readouterr()
    assert out.out.strip().splitlines() == [json.dumps(result)]  # stdout: the JSON line alone
    assert "TF32 off" in out.err
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line == result
    for key in ("metric", "value", "unit", "vs_baseline", "mfu", "ms", "device"):
        assert key in line, key
    assert line["metric"] == "conv_tasnet_wsj0mix_inference_rtf"
    assert line["unit"] == "audio_seconds_per_second_per_chip"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 10)
    assert line["mfu"] is None and line["device"] == "cpu"  # no card, no peak to divide by
    dprnn = bench.main(TINY_RUN + ["--model", "dprnn-tasnet", "--rnn_type", "gru",
                                   "--dtype", "float32"])
    assert dprnn["metric"] == "dprnn_tasnet_wsj0mix_inference_rtf" and dprnn["ms"] > 0
    dptnet = bench.main(TINY_RUN + ["--model", "dptnet", "--causal", "--dtype", "float32"])
    assert dptnet["metric"] == "dptnet_wsj0mix_inference_rtf" and dptnet["ms"] > 0
    assert dptnet["flops"] == sum(bench.forward_flops(
        DPTNet(**dict(DPTNET_TINY, causal=True), device="meta"), 2000, bench.BATCH).values())


@pytest.mark.parametrize("model", ["conv-tasnet", "dprnn-tasnet"])
def test_streaming_json_line(tiny_bench, model):
    result = bench.main(TINY_RUN + ["--model", model, "--causal", "--streaming_hop", "0.05",
                                    "--dtype", "float32"])
    assert result["metric"] == f"{model.replace('-', '_')}_streaming_ms_per_hop"
    assert result["unit"] == "ms" and result["hops"] == 5 and result["hop_ms"] == 50.0
    assert result["p90_ms"] >= result["value"] > 0
    assert result["real_time_factor"] == pytest.approx(result["value"] / 50.0)


def test_streaming_needs_a_causal_model(tiny_bench):
    with pytest.raises(ValueError, match="causal"):
        bench.main(TINY_RUN + ["--streaming_hop", "0.05"])


@pytest.mark.parametrize("model", ["umx", "xumx"])
def test_musdb_json_line(tiny_musdb_bench, capsys, model):
    result = bench.main(TINY_RUN + ["--model", model])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert line["metric"] == f"{model}_musdb18_track_rtf"
    assert line["unit"] == "audio_seconds_per_second_per_chip" and line["dtype"] == "float32"
    assert line["chunks"] == 3 and line["seconds"] == pytest.approx(0.6)  # the last padded
    assert line["value"] == pytest.approx(line["seconds"] / (line["ms"] / 1e3))
    assert sorted(line["stage_ms"]) == ["forward", "istft", "stft", "wiener"]
    assert line["model_stft_ms"] > 0 and line["wiener_istft_ms"] > 0


def test_musdb_bench_refuses_bfloat16_and_streaming(tiny_musdb_bench):
    for flags in (["--dtype", "bfloat16"], ["--streaming_hop", "0.05", "--causal"]):
        with pytest.raises(ValueError, match="float32 offline only"):
            bench.main(TINY_RUN + ["--model", "umx", *flags])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_entry_on_the_cpu():
    forward, (model, mixture) = entry(device="cpu")
    assert mixture.shape == (1, 1, 32000) and model.n_basis == 512 and not model.causal
    assert model.num_parameters() == flagship(device="meta").num_parameters()


def _recipe_argv(path):
    """The arguments a recipe shell passes to its CLI, its variables given values."""
    text = path.read_text()
    command = re.search(r"python -m (\S+) \\\n(.*?)\| tee", text, re.S)
    module, body = command.group(1), command.group(2).replace("\\\n", " ")
    body = re.sub(r'"\$\{?(\w+)\}?([^"]*)"', lambda m: f"{m.group(1)}{m.group(2)}", body)
    return module, [a for a in shlex.split(body) if a != "$@"]


@pytest.mark.parametrize("model", ["conv-tasnet", "dprnn-tasnet", "dptnet"])
def test_recipe_shells_parse_with_the_ports_parsers(model):
    module, argv = _recipe_argv(RECIPES / model / "train.sh")
    assert module == "dnn_based_source_separation_torch.cli.train_wsj0mix"
    args = train_wsj0mix.build_parser().parse_args(argv)
    assert args.model == model and args.device == "device"
    if model == "conv-tasnet":  # the paper config (egs/wsj0-mix/conv-tasnet/train.sh:14-20)
        assert (args.n_basis, args.kernel_size, args.sep_hidden_channels,
                args.sep_bottleneck_channels, args.sep_skip_channels, args.sep_kernel_size,
                args.sep_num_blocks, args.sep_num_layers, args.batch_size) == \
            (512, 16, 512, 128, 128, 3, 3, 8, 4)
    elif model == "dptnet":  # egs/wsj0-mix/dptnet/train.sh
        assert (args.n_basis, args.kernel_size, args.sep_chunk_size, args.sep_num_blocks,
                args.sep_num_heads, args.sep_bottleneck_channels, args.sep_hidden_channels,
                args.mask_nonlinear, args.batch_size, args.warmup_steps, args.k1, args.k2) == \
            (64, 2, 100, 6, 4, 64, 256, "relu", 2, 4000, 0.2, 4e-4)
    else:  # egs/wsj0-mix/dprnn-tasnet/train.sh:17-23
        assert (args.n_basis, args.kernel_size, args.sep_chunk_size, args.sep_hop_size,
                args.sep_num_blocks, args.sep_bottleneck_channels, args.sep_hidden_channels,
                args.batch_size) == (64, 2, 250, 125, 6, 64, 128, 2)
    module, argv = _recipe_argv(RECIPES / model / "test.sh")
    assert module == "dnn_based_source_separation_torch.cli.test_wsj0mix"
    args = test_wsj0mix.build_parser().parse_args(argv)
    assert args.device == "device" and args.model_path.endswith(".ckpt")
    assert "common/path.sh" not in (RECIPES / model / "train.sh").read_text()


@pytest.mark.parametrize("model", ["umx", "x-umx"])
def test_musdb_recipe_shells_parse_with_the_ports_parser(model):
    module, argv = _recipe_argv(MUSDB_RECIPES / model / "test.sh")
    assert module == "dnn_based_source_separation_torch.cli.test_musdb18"
    args = test_musdb18.build_parser().parse_args(argv)
    assert args.device == "device" and args.model_path.endswith(".ckpt")
    assert args.musdb18_root == "musdb18_root" and args.out_dir == "exp_dir/test"
    assert test_musdb18.build_parser().parse_args(["--musdb18_root", "r", "--model_path",
                                                   "m"]).device == "cuda"
