"""The recipe YAMLs (`egs/musdb18/*/config/*.yaml`) and the models built from them.

Port of `dnn_based_source_separation_tpu/utils/config.py` (`build_umx_from_config`,
`build_d3net_from_config`, `build_mmdensenet_from_config`,
`build_mmdenselstm_from_config`). JAX reads the files with `yaml.safe_load`; the port
has no YAML library, so it reads them with `load_yaml`, which takes the subset those
files use and raises on anything else:

- mappings nested by indentation (spaces), one `key: value` or `key:` a line;
- inline lists `[a, b]` of scalars;
- scalars: decimal ints, floats with a point (`0.4`, `1.0e-3`; YAML 1.1 reads `1e-3` as
  a string, and this raises on it), `True` / `False` (any of YAML's three cases), bare
  words (`yes`, `no`, `on`, `off` and `null`, which YAML reads otherwise, raise);
- `#` comments, whole-line or after a value, and blank lines.

It returns what `yaml.safe_load` returns on such a file.
"""
from __future__ import annotations

import re

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
_WORD = re.compile(r"[A-Za-z_][A-Za-z0-9_\-]*")
_BOOLS = {"True": True, "true": True, "TRUE": True, "False": False, "false": False,
          "FALSE": False}
# Plain words YAML 1.1 reads as booleans or null (in any case here): refused.
_RESERVED = {"yes", "no", "on", "off", "null"}
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_\-]*):(?:\s+(.*))?$")


def _scalar(text: str, where: str):
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _BOOLS:
        return _BOOLS[text]
    if _WORD.fullmatch(text) and text.lower() not in _RESERVED:
        return text
    raise ValueError(f"{where}: unsupported YAML value {text!r}")


def _value(text: str, where: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unsupported YAML list {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(v.strip(), where) for v in inner.split(",")] if inner else []
    return _scalar(text, where)


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (a `#` at the start or after a space)."""
    match = re.search(r"(^|\s)#", line)
    return (line[:match.start()] if match else line).rstrip()


def load_yaml(path: str) -> dict:
    """The recipe YAML at `path` -> nested dicts, lists and scalars (as `yaml.safe_load`)."""
    root: dict = {}
    stack = [(0, root)]  # (indent, mapping) of the open mappings
    pending = None  # (indent, key, parent) of a `key:` whose mapping has not begun
    with open(path) as f:
        lines = f.read().splitlines()
    for number, raw in enumerate(lines, 1):
        where = f"{path}:{number}"
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tabs in the indentation")
        indent = len(line) - len(line.lstrip(" "))
        match = _KEY.fullmatch(line.strip())
        if match is None:
            raise ValueError(f"{where}: unsupported YAML line {raw!r}")
        key, text = match.group(1), (match.group(2) or "").strip()
        if pending is not None:
            p_indent, p_key, parent = pending
            if indent > p_indent:  # the pending key's mapping begins here
                parent[p_key] = {}
                stack.append((indent, parent[p_key]))
            else:
                parent[p_key] = None
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if text:
            mapping[key] = _value(text, where)
        else:
            pending = (indent, key, mapping)
    if pending is not None:
        pending[2][pending[1]] = None
    return root


def build_umx_from_config(config_path: str, *, generator=None, device=None):
    """YAML (in_channels, hidden_channels, num_layers, n_bins, max_bin, drop_out, causal)
    -> OpenUnmix."""
    from ..models.umx import OpenUnmix

    cfg = load_yaml(config_path)
    return OpenUnmix(in_channels=cfg["in_channels"],
                     hidden_channels=cfg.get("hidden_channels", 512),
                     num_layers=cfg.get("num_layers", 3), n_bins=cfg["n_bins"],
                     max_bin=cfg.get("max_bin"), dropout=cfg.get("drop_out", cfg.get("dropout")),
                     causal=cfg.get("causal", False), generator=generator, device=device)


def _per_band(cfg: dict):
    keys = [*cfg["bands"], "full"]

    def per_band(key, default=None):
        return {b: cfg[b].get(key, default) for b in keys}

    return per_band


def band_kwargs(config_path: str, dilated: bool) -> tuple:
    """The band-structured YAML -> (its dict, the per-band and final keyword arguments
    shared by D3Net, MMDenseNet and MMDenseLSTM)."""
    cfg = load_yaml(config_path)
    bands = list(cfg["bands"])
    per_band, final = _per_band(cfg), cfg["final"]
    return cfg, dict(
        in_channels=cfg["in_channels"], num_features=per_band("num_features"),
        growth_rate=per_band("growth_rate"), kernel_size=per_band("kernel_size", 3),
        bands=bands, sections=[cfg[b]["sections"] for b in bands], scale=per_band("scale", 2),
        dilated=per_band("dilated", dilated), norm=per_band("norm", True),
        nonlinear=per_band("nonlinear", "relu"), depth=per_band("depth"),
        growth_rate_final=final["growth_rate"], kernel_size_final=final.get("kernel_size", 3),
        dilated_final=final.get("dilated", dilated), norm_final=final.get("norm", True),
        nonlinear_final=final.get("nonlinear", "relu"), depth_final=final.get("depth"))


def build_d3net_from_config(config_path: str, parallel: bool = False,
                            sources=("bass", "drums", "other", "vocals"), *, generator=None,
                            device=None):
    """Band-structured YAML (`egs/musdb18/d3net/config/vocals.yaml`) -> D3Net, or with
    `parallel` one a stem (ParallelD3Net)."""
    from ..models.d3net import D3Net, ParallelD3Net

    cfg, kwargs = band_kwargs(config_path, dilated=True)
    kwargs.update(num_d2blocks=_per_band(cfg)("num_d2blocks"), generator=generator,
                  device=device)
    if parallel:
        return ParallelD3Net(sources=tuple(sources), **kwargs)
    return D3Net(**kwargs)


def build_mmdensenet_from_config(config_path: str, parallel: bool = False,
                                 sources=("bass", "drums", "other", "vocals"), *,
                                 generator=None, device=None):
    """Band-structured YAML (`egs/musdb18/mm-densenet/config/paper.yaml`) -> MMDenseNet, or
    with `parallel` ParallelMMDenseNet."""
    from ..models.mm_densenet import MMDenseNet, ParallelMMDenseNet

    _, kwargs = band_kwargs(config_path, dilated=False)
    kwargs.update(generator=generator, device=device)
    if parallel:
        return ParallelMMDenseNet(sources=tuple(sources), **kwargs)
    return MMDenseNet(**kwargs)


def build_mmdenselstm_from_config(config_path: str, parallel: bool = False,
                                  sources=("bass", "drums", "other", "vocals"), *,
                                  generator=None, device=None):
    """Band-structured YAML (`egs/musdb18/mm-dense-lstm/config/paper.yaml`: per-stage
    hidden_channels, rnn_position, rnn_type, causal) -> MMDenseLSTM, or with `parallel`
    ParallelMMDenseLSTM."""
    from ..models.mm_dense_rnn import MMDenseLSTM, ParallelMMDenseLSTM

    cfg, kwargs = band_kwargs(config_path, dilated=False)
    position = {"parallel": "parallel", "after_dense": "after",
                "before_dense": "before"}[cfg.get("rnn_position", "parallel")]
    kwargs.update(hidden_channels=_per_band(cfg)("hidden_channels", 0),
                  hidden_channels_final=cfg["final"].get("hidden_channels", 0),
                  causal=cfg.get("causal", False), rnn_type=cfg.get("rnn_type", "lstm"),
                  rnn_position=position, generator=generator, device=device)
    if parallel:
        return ParallelMMDenseLSTM(sources=tuple(sources), **kwargs)
    return MMDenseLSTM(**kwargs)
