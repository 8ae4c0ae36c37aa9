"""The port stands alone: every module of ``repro_torch`` (the training
modules ``repro_torch.train`` and ``repro_torch.data`` among them) imports
with ``jax`` and ``repro`` made unimportable, without pulling in ``triton``
or building a kernel; and its copies of the configs (model, parallel, train,
data) and layer plans have not drifted from the JAX package's."""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import config as jax_config
from repro import data as jax_data
from repro.models.model import layer_plans as jax_layer_plans
from repro.models.model import segment_plans as jax_segment_plans
from repro_torch import config as tcfg
from repro_torch import data as tdata
from repro_torch.models.model import layer_plans, segment_plans

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Reject(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, Reject())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    assert "triton" not in sys.modules, "importing the port pulled in triton"
    for name in ("repro_torch.data", "repro_torch.train", "repro_torch.train.optimizer",
                 "repro_torch.train.train_step"):
        assert name in names, name
    print(len(names), "modules")
""")


def test_every_module_imports_without_jax_or_repro(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 29
    assert not list(tmp_path.iterdir())          # nothing built or written


def port_config(cfg) -> tcfg.ModelConfig:
    d = dataclasses.asdict(cfg)
    d["attention"] = tcfg.AttentionConfig(**d["attention"]) if d["attention"] else None
    d["moe"] = tcfg.MoEConfig(**d["moe"])
    d["ssm"] = tcfg.SSMConfig(**d["ssm"]) if d["ssm"] else None
    return tcfg.ModelConfig(**d)


@pytest.mark.parametrize("getter", ["get_arch", "get_smoke"])
def test_configs_equal_jax_field_for_field(getter):
    assert tcfg.list_archs() == ["mamba2-1.3b", "smollm-360m"]
    for name in tcfg.list_archs():
        port = getattr(tcfg, getter)(name)
        ref = getattr(jax_config, getter)(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.padded_vocab == ref.padded_vocab
        assert [port.is_attn_layer(i) for i in range(port.num_layers)] == \
            [ref.is_attn_layer(i) for i in range(ref.num_layers)]


def _fields(cls) -> list:
    return [(f.name, dataclasses.asdict(f.default)
             if dataclasses.is_dataclass(f.default) else f.default)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["AttentionConfig", "MoEConfig", "SSMConfig",
                                  "ModelConfig", "ParallelConfig", "TrainConfig",
                                  "data.DataConfig"])
def test_dataclass_fields_and_defaults_equal_jax(name):
    if name.startswith("data."):
        ours, theirs = tdata, jax_data
        name = name[5:]
    else:
        ours, theirs = tcfg, jax_config
    assert _fields(getattr(ours, name)) == _fields(getattr(theirs, name))


@pytest.mark.parametrize("smoke", [False, True])
def test_layer_and_segment_plans_equal_jax_on_every_arch(smoke):
    names = jax_config.list_archs()
    assert len(names) >= 12
    for name in names:
        try:
            ref = (jax_config.get_smoke if smoke else jax_config.get_arch)(name)
        except KeyError:
            continue
        cfg = port_config(ref)
        for decoder in (True, False):
            ours = layer_plans(cfg, decoder=decoder)
            theirs = jax_layer_plans(ref, decoder=decoder)
            assert [dataclasses.asdict(p) for p in ours] == \
                [dataclasses.asdict(p) for p in theirs], name
            segs, ref_segs = segment_plans(ours), jax_segment_plans(theirs)
            assert [(tuple(dataclasses.asdict(p) for p in s.pattern), s.repeat)
                    for s in segs] == \
                [(tuple(dataclasses.asdict(p) for p in s.pattern), s.repeat)
                 for s in ref_segs], name
