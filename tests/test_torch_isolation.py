"""The port stands apart from the JAX package.

* No module of ``src/repro_torch/`` and not ``chip_smoke.py`` imports
  ``jax`` or ``repro`` (AST scan, relative imports resolved).
* The port's copied configs equal ``repro.configs`` field by field.
* Entry points run on CUDA by default and raise without a GPU unless the
  caller passes ``device="cpu"``.
"""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import AdapterStore, Engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg = path.relative_to(ROOT / "src").parent.parts \
        if PORT in path.parents else ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                yield ".".join(base + ((node.module,) if node.module
                                       else ()))
            else:
                yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_relative_imports_resolve_inside_the_port():
    mods = set(_imported_modules(PORT / "serve" / "engine.py"))
    assert "repro_torch.models.lm" in mods and "repro_torch" in mods


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_configs_equal_the_reference_field_by_field(name):
    mine, ref = configs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == \
        dataclasses.asdict(ref.reduced())
    assert mine.resolved_head_dim == ref.resolved_head_dim


def test_train_config_fields_equal_the_reference_defaults():
    mine, ref = configs.TrainConfig(), jconfigs.TrainConfig()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(ref, f.name), f.name


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    cfg = configs.get_config("llama-tiny").reduced()
    tcfg = configs.TrainConfig(rank=4, min_dim_for_lowrank=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AdapterStore(cfg, tcfg, max_tenants=1)
    params = lm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg)
    eng = Engine(params, cfg, device="cpu")
    assert eng.device.type == "cpu"
