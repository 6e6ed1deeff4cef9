"""The port's config loader and builder (``clover_tpu_torch/config.py``,
``clover_tpu_torch/builder.py``) held against the JAX package's on every
experiment config.

The builder must give each JAX config its JAX meaning: every field the port
shares with the JAX dataclasses equal, and the port's own fields at the
values the JAX package runs (``embed_impl`` 'conv' unless set, the MLP
stash off under remat, the attention and MLP routes at the JAX environment
defaults). For the three debug configs the built model's parameters are
the JAX ``model.init`` tree, leaf for leaf and shape for shape (its
``param_table`` reads the same).
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from clover_tpu import builder as jbuilder
from clover_tpu import config as jconfig
from clover_tpu.utils.logging import param_table as jparam_table
from clover_tpu_torch import builder as pbuilder
from clover_tpu_torch import config as pconfig
from clover_tpu_torch.utils.logging import param_table as pparam_table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "exp", "*.py")))
DEBUG = [c for c in CONFIGS if os.path.basename(c).startswith("debug_")]
# the port's fields that the JAX dataclasses lack, at the JAX package's values
PORT_SWIN = dict(fused_attn="auto", long_attn="off", mlp_bwd="xla")


def _name(path):
    return os.path.splitext(os.path.basename(path))[0]


def _assert_shared_fields_equal(got, want, what):
    mine = {f.name for f in dataclasses.fields(got)}
    theirs = {f.name for f in dataclasses.fields(want)}
    for name in sorted(mine & theirs):
        g, w = getattr(got, name), getattr(want, name)
        if dataclasses.is_dataclass(g):
            _assert_shared_fields_equal(g, w, f"{what}.{name}")
        else:
            assert g == w, f"{what}.{name}: port {g!r}, JAX {w!r}"
    return mine - theirs, theirs - mine


def test_every_experiment_config_is_found():
    assert len(CONFIGS) >= 20 and len(DEBUG) == 3


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_load_config_matches_jax(path):
    got, want = pconfig.load_config(path), jconfig.load_config(path)
    assert isinstance(got, pconfig.Config)
    assert got.to_dict() == want.to_dict()
    assert got.model["type"] == want.model["type"]


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_builder_configs_match_jax_field_by_field(path):
    cfg = jconfig.load_config(path).to_dict()
    m = cfg["model"]
    swin = pbuilder.build_swin_config(m.get("swin", {}))
    jswin = jbuilder.build_swin_config(m.get("swin", {}))
    only_port, only_jax = _assert_shared_fields_equal(swin, jswin, "swin")
    assert only_port == set(PORT_SWIN) | {"mlp_stash"}
    assert only_jax == {"act_sharding", "fused_mlp"}
    for k, v in PORT_SWIN.items():
        assert getattr(swin, k) == v
    assert swin.mlp_stash == (not jswin.use_checkpoint)
    assert swin.embed_impl == m.get("swin", {}).get("embed_impl", "conv")

    bert = pbuilder.build_bert_config(m.get("text_bert", {}))
    only_port, only_jax = _assert_shared_fields_equal(
        bert, jbuilder.build_bert_config(m.get("text_bert", {})), "text_bert")
    assert only_port == {"fused_mlp_train"} and not only_jax and bert.fused_mlp_train == "0"
    fusion = pbuilder.build_fusion_config(m.get("fusion", {}), bert)
    _assert_shared_fields_equal(
        fusion, jbuilder.build_fusion_config(m.get("fusion", {}),
                                             jbuilder.build_bert_config(m.get("text_bert", {}))),
        "fusion")

    pmodel, pmc = pbuilder.build_model(m, device="meta")
    jmodel, jmc = jbuilder.build_model(m)
    only_port, only_jax = _assert_shared_fields_equal(pmc, jmc, m["type"])
    assert not only_port
    for name in only_jax:   # the JAX pretrain switches the port keeps on
        assert getattr(jmc, name) == pbuilder._PRETRAIN_FIXED[name], name
    assert pmodel.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[m["dtype"]]
    assert jmodel.dtype == jax.numpy.dtype(m["dtype"])


def test_builder_refuses_what_the_port_does_not_run():
    with pytest.raises(ValueError, match="act_sharding"):
        pbuilder.build_swin_config({"act_sharding": ("data", None, "sp", None, None)})
    with pytest.raises(ValueError, match="use_mlm"):
        pbuilder.build_model({"type": "CloverPretrain", "dtype": "float32", "use_mlm": False},
                             device="meta")
    with pytest.raises(ValueError, match="use_rank"):
        pbuilder.build_pretrain_loss_config({"model": {"ssl_loss": {"use_rank": False}}})
    with pytest.raises(ValueError, match="unknown model type"):
        pbuilder.build_model({"type": "Clover", "dtype": "float32"}, device="meta")


def test_builder_port_only_fields_follow_the_config():
    """An explicit embed_impl or mlp_stash wins; use_checkpoint turns the
    stash off (the JAX builder's CLOVER_MLP_STASH=0 for remat recipes)."""
    assert pbuilder.build_swin_config({"embed_impl": "s2d"}).embed_impl == "s2d"
    assert not pbuilder.build_swin_config({"use_checkpoint": [0, 1]}).mlp_stash
    assert pbuilder.build_swin_config({"use_checkpoint": [0, 1]}).use_checkpoint == (0, 1)
    assert pbuilder.build_swin_config({"use_checkpoint": True, "mlp_stash": True}).mlp_stash
    assert pbuilder.build_swin_config({"variant": "tiny"}).depths == (2, 2, 6, 2)
    loss = pbuilder.build_pretrain_loss_config(
        {"model": {"ssl_loss": {"temperature": 0.07, "margin_ttm": 3.0},
                   "mlm_loss": {"gamma": 1.5}}})
    assert (loss.nce_temperature, loss.margin_ttm, loss.mlm_focal_gamma) == (0.07, 3.0, 1.5)


def test_parse_cfg_options_and_overrides_match_jax():
    pairs = ["total_epochs=3", "model.swin.embed_dim=16", "data.train_loader.batch_size=4",
             "optimizer.betas=(0.9, 0.99)", "work_dir=/tmp/x", "model.dtype=bfloat16",
             "ema.enabled=True", "evaluation.save_best=Recall@1"]
    got, want = pconfig.parse_cfg_options(pairs), jconfig.parse_cfg_options(pairs)
    assert got == want
    path = DEBUG[0]
    a = pconfig.load_config(path, overrides=got)
    b = jconfig.load_config(path, overrides=want)
    assert a.to_dict() == b.to_dict()
    assert a.optimizer.betas == (0.9, 0.99) and a.model.swin.embed_dim == 16
    assert a.ema.enabled is True and a.work_dir == "/tmp/x"
    with pytest.raises(ValueError, match="key=value"):
        pconfig.parse_cfg_options(["total_epochs"])


def test_merge_dict_delete_and_base_chain_match_jax(tmp_path):
    base = {"a": {"x": 1, "y": [1, 2]}, "b": 2}
    over = {"a": {"_delete_": True, "z": 3}, "c": {"d": 4}}
    assert pconfig.merge_dict(base, over) == jconfig.merge_dict(base, over) == {
        "a": {"z": 3}, "b": 2, "c": {"d": 4}}
    (tmp_path / "base.py").write_text("model = dict(a=1, b=dict(c=2))\nlr = 0.1\n")
    (tmp_path / "mid.py").write_text("_base_ = 'base.py'\nmodel = dict(b=dict(d=3))\n")
    (tmp_path / "top.py").write_text(
        "_base_ = ['mid.py']\nmodel = dict(b=dict(_delete_=True, e=4))\n"
        "def helper():\n    return 1\n")
    got = pconfig.load_config(str(tmp_path / "top.py"))
    assert got.to_dict() == jconfig.load_config(str(tmp_path / "top.py")).to_dict() == {
        "model": {"a": 1, "b": {"e": 4}}, "lr": 0.1}
    got.dump(str(tmp_path / "cfg.json"))
    assert (tmp_path / "cfg.json").read_text().startswith("{")


def _jax_init_shapes(path):
    """The JAX ``model.init`` tree's shapes (jax.eval_shape, no compile) on
    the sample batch tools/train.py inits with."""
    from clover_tpu.ops.preprocess import preprocess_clips

    cfg = jconfig.load_config(path)
    tok = jbuilder.build_tokenizer(cfg.tokenizer) if cfg.get("tokenizer") else None
    train = cfg.data.train if isinstance(cfg.data.train, dict) else cfg.data.train[0]
    ds = jbuilder.build_dataset(train, tok)
    host = next(iter(jbuilder.build_loader(ds, {"batch_size": 2, "num_workers": 1})))
    model, _ = jbuilder.build_model(cfg.model)
    imgs = preprocess_clips(host["imgs"].reshape((-1,) + host["imgs"].shape[2:]),
                            host["crop_boxes"], host["flip"], out_size=cfg.img_size,
                            dtype=model.dtype)
    sample = {"imgs": imgs.reshape((-1, host["imgs"].shape[1]) + imgs.shape[1:]),
              **{k: host[k] for k in ("token_ids", "input_mask", "mlm_label", "v_token_mask",
                                      "label") if k in host}}
    return cfg, jax.eval_shape(lambda s: model.init(jax.random.PRNGKey(0), s, train=False),
                               sample)["params"]


@pytest.mark.parametrize("path", DEBUG, ids=_name)
def test_debug_config_model_is_the_jax_init_tree(path):
    cfg, shapes = _jax_init_shapes(path)
    model, _ = pbuilder.build_model(cfg.model, device="cpu")
    want = {"/".join(k.key for k in p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(shapes)}
    table = pparam_table(model)
    got = {}
    for line in table.splitlines()[1:-1]:
        name, rest = line.split(None, 1)
        got[name] = tuple(int(d) for d in rest.split(")")[0].strip("( ").split(",") if d.strip())
    assert got == want
    assert table == jparam_table(shapes)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in want.values())
