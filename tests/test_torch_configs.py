"""The port's architecture registry, against the JAX package's.

``repro_torch.configs`` is a copy of ``repro.configs`` with its imports
pointed at the port's config classes: the same 11 architectures, every
``config``, ``smoke_config`` and shape equal field by field, the same
assigned grid (40 cells, 43 with ``repair-ir``) and the same parameter
counts.
"""

import dataclasses

import pytest

from repro.configs import get_arch as get_arch_jax
from repro.configs import list_archs as list_archs_jax
from repro.launch.specs import all_cells as all_cells_jax

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch.specs import all_cells
from repro_torch.models import transformer as TT

ARCHS = list_archs_jax()
LM_ARCHS = [a for a in ARCHS if get_arch_jax(a).family == "lm"]


def _fields(cfg) -> tuple[str, dict]:
    return type(cfg).__name__, dataclasses.asdict(cfg)


def test_list_archs_equal():
    assert list_archs() == ARCHS
    assert len(ARCHS) == 11


@pytest.mark.parametrize("name", ARCHS)
def test_arch_spec_equal(name):
    ours, ref = get_arch(name), get_arch_jax(name)
    assert (ours.name, ours.family, ours.source) == \
        (ref.name, ref.family, ref.source)
    assert _fields(ours.config) == _fields(ref.config)
    assert _fields(ours.smoke_config) == _fields(ref.smoke_config)
    assert [_fields(s) for s in ours.shapes] == \
        [_fields(s) for s in ref.shapes]
    for s in ref.shapes:
        assert ours.shape(s.name).params == s.params
    with pytest.raises(KeyError):
        ours.shape("no-such-shape")


def test_all_cells_equal():
    assert len(all_cells(include_repair_ir=False)) == 40
    assert len(all_cells(include_repair_ir=True)) == 43
    assert all_cells() == all_cells_jax()
    assert all_cells(False) == all_cells_jax(False)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_param_counts_equal(name):
    for attr in ("config", "smoke_config"):
        ours = getattr(get_arch(name), attr)
        ref = getattr(get_arch_jax(name), attr)
        assert ours.padded_vocab == ref.padded_vocab
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()


def test_yi_6b_full_size():
    """The configuration the card serves at full width and depth."""
    cfg = get_arch("yi-6b").config
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab, cfg.padded_vocab) == (32, 4096, 32, 4, 11008, 64000,
                                             64000)
    # per layer: wq, wo 4096², wk, wv 4096 x 512, three 4096 x 11008
    # projections, two norms; then embed and unembed 64000 x 4096, ln_f
    per_layer = 2 * 4096 ** 2 + 2 * 4096 * 512 + 3 * 4096 * 11008 + 2 * 4096
    assert cfg.param_count() == 32 * per_layer + 2 * 64000 * 4096 + 4096 \
        == 6_061_035_520
    two = dataclasses.replace(cfg, n_layers=2)
    assert two.param_count() == 870_338_560


@pytest.mark.parametrize("field", ["dp_spec", "tp_axis", "mesh", "sp_axis",
                                   "attn_head_shard", "moe_ep_pad"])
def test_mesh_wiring_refused(field):
    """The reference's mesh wiring takes the port's ``Mesh``: a config
    with any other mesh is refused at once, whatever else it sets; the
    fields alone are accepted, as the reference accepts them."""
    cfg = get_arch("phi3.5-moe-42b-a6.6b").smoke_config
    value = True if field in ("attn_head_shard", "moe_ep_pad") else "model"
    with pytest.raises(TypeError, match="mesh"):
        dataclasses.replace(cfg, **{"mesh": "model", field: value})
    if field != "mesh":
        assert getattr(dataclasses.replace(cfg, **{field: value}),
                       field) == value
    assert dataclasses.replace(cfg, unroll_layers=True).unroll_layers
    assert isinstance(cfg, TT.LMConfig)
