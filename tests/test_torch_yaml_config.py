"""The port's recipe-YAML reader and model builders (`utils/config.py`) against PyYAML and
the JAX package's builders (CPU).

`load_yaml` returns what `yaml.safe_load` returns on every `egs/musdb18/*/config/*.yaml`,
and on small documents of each construct it takes; it raises on the constructs it does
not take. Each builder gives the model JAX's builder gives on the recipe YAML: the same
configuration, field by field, and at recipe widths the bins each recurrence reads.
"""
import dataclasses
import pathlib

import pytest
import yaml

from dnn_based_source_separation_torch.models import D3Net, MMDenseLSTM, MMDenseNet, OpenUnmix
from dnn_based_source_separation_torch.utils import config as port_config
from dnn_based_source_separation_tpu.utils import config as jax_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
RECIPE_YAMLS = sorted((ROOT / "egs" / "musdb18").glob("*/config/*.yaml"))


@pytest.mark.parametrize("path", RECIPE_YAMLS, ids=lambda p: f"{p.parent.parent.name}")
def test_load_yaml_matches_safe_load_on_the_recipes(path):
    assert port_config.load_yaml(str(path)) == yaml.safe_load(path.read_text())


DOCUMENTS = {
    "nested": "a:\n  b: 1\n  c:\n    d: [1, 2]\n  e: x\nf: 2\n",
    "scalars": "i: -3\nf: 0.4\ng: 1.0e-3\nt: True\nu: false\ns: after_dense\n",
    "comments": "# head\na: 1  # trailing\n\nb: [x, y]   # list\n# tail\n",
    "empty-list": "a: []\nb:\n",
    "dedent": "a:\n  b:\n    c: 1\nd: 2\n",
}


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_load_yaml_matches_safe_load_on_each_construct(name, tmp_path):
    path = tmp_path / "doc.yaml"
    path.write_text(DOCUMENTS[name])
    assert port_config.load_yaml(str(path)) == yaml.safe_load(DOCUMENTS[name])


REFUSED = {
    "block-list": "a:\n  - 1\n  - 2\n",
    "quoted": "a: 'x'\n",
    "flow-mapping": "a: {b: 1}\n",
    "yes": "a: yes\n",
    "exponent-only": "a: 1e-3\n",  # YAML 1.1 reads a string; a recipe means a number
    "null": "a: null\n",
    "anchor": "a: &x 1\n",
    "tab": "a:\n\tb: 1\n",
    "bad-indent": "a:\n    b: 1\n  c: 2\n",
    "duplicate": "a: 1\na: 2\n",
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_load_yaml_raises_on_what_it_does_not_take(name, tmp_path):
    path = tmp_path / "doc.yaml"
    path.write_text(REFUSED[name])
    with pytest.raises(ValueError):
        port_config.load_yaml(str(path))


def _frozen(v):
    if isinstance(v, dict):
        return {k: _frozen(u) for k, u in v.items()}
    return tuple(_frozen(u) for u in v) if isinstance(v, (list, tuple)) else v


BUILDERS = {  # builder name, recipe YAML, port class
    "umx": ("build_umx_from_config", "umx/config/vocals.yaml", OpenUnmix),
    "d3net": ("build_d3net_from_config", "d3net/config/vocals.yaml", D3Net),
    "mm-densenet": ("build_mmdensenet_from_config", "mm-densenet/config/paper.yaml",
                    MMDenseNet),
    "mm-dense-lstm": ("build_mmdenselstm_from_config", "mm-dense-lstm/config/paper.yaml",
                      MMDenseLSTM),
}


@pytest.mark.parametrize("kind", list(BUILDERS))
def test_builders_match_jax_builders_on_the_recipes(kind):
    name, recipe, cls = BUILDERS[kind]
    path = str(ROOT / "egs" / "musdb18" / recipe)
    port, jmodel = getattr(port_config, name)(path), getattr(jax_config, name)(path)
    assert type(port) is cls
    fields = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)
              if f.name not in ("parent", "name")}
    config = port.get_config()
    for field, value in fields.items():
        assert _frozen(config[field]) == _frozen(value), field
    if kind == "mm-dense-lstm":  # the recurrences read the bins at their scale
        low, high, full = (port.net[b] for b in ("low", "high", "full"))
        assert low.bottleneck_conv2d.rnn.input_size == 48  # 380 bins, three halvings up
        assert low.bottleneck_conv2d.rnn.hidden_size == 64
        assert high.bottleneck_conv2d.rnn.input_size == 257  # 1025 -> 513 -> 257
        assert high.bottleneck_conv2d.rnn.hidden_size == 4
        assert low.decoder.net[1].dense_rnn_block.rnn.input_size == 190
        assert port.net["middle"].bottleneck_conv2d.rnn.hidden_size == 16
        assert full.bottleneck_conv2d.rnn.input_size == 129  # 2049 at 1/16
        assert full.decoder.net[2].dense_rnn_block.rnn.input_size == 1025


@pytest.mark.parametrize("kind", ["d3net", "mm-densenet", "mm-dense-lstm"])
def test_parallel_builders_give_one_model_a_stem(kind):
    name, recipe, cls = BUILDERS[kind]
    path = str(ROOT / "egs" / "musdb18" / recipe)
    port = getattr(port_config, name)(path, parallel=True, sources=("drums", "vocals"))
    assert list(port.net) == ["drums", "vocals"] and port.sources == ["drums", "vocals"]
    assert all(type(m) is cls for m in port.net.values())
    assert port.get_config()["sources"] == ("drums", "vocals")
