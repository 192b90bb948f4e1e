"""Entry points: the compile-check entry, the multi-device dry run, the
compile-cache location, and the helpers of chip_smoke.py."""

import json
import os
import sys

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def test_entry_matches_golden():
    from __graft_entry__ import entry
    from dasp_tpu.sparse import mixed_categories
    fn, args = entry()
    y = np.asarray(jax.jit(fn)(*args), dtype=np.float64)
    csr = mixed_categories(2048, np.random.default_rng(7))
    golden = csr.spmv(np.asarray(args[1], dtype=np.float64))
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(y / scale, golden / scale,
                               rtol=1e-5, atol=1e-5)


def test_dryrun_multichip_four(capsys):
    from __graft_entry__ import dryrun_multichip
    dryrun_multichip(4)
    assert "4-device SpMV matches golden" in capsys.readouterr().out


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(tmp_path, monkeypatch, env_set):
    from dasp_tpu.utils import enable_compile_cache
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        want = str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(ROOT, ".jax_cache")
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert os.path.isdir(want)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_smoke_refuses_cpu():
    import chip_smoke
    with pytest.raises(chip_smoke.SmokeError, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_smoke_last_line_schema():
    import chip_smoke
    line = chip_smoke.ok_line(jax.devices()[:4])
    assert "\n" not in line
    d = json.loads(line)
    assert d == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": 4}}


def test_smoke_parses_nvidia_smi():
    import chip_smoke
    assert chip_smoke.parse_smi_line("NVIDIA H100 80GB HBM3, 700.00 W") == (
        "NVIDIA H100 80GB HBM3", "700.00 W")
    for bad in ("", "NVIDIA H100", ", 700.00 W", "NVIDIA H100,"):
        with pytest.raises(ValueError):
            chip_smoke.parse_smi_line(bad)


@pytest.mark.parametrize("visible,ordinal,want", [
    (None, 2, "2"), ("3,1", 1, "1"), ("GPU-a1b2, GPU-c3d4", 1, "GPU-c3d4")])
def test_smi_id_names_the_card_jax_uses(monkeypatch, visible, ordinal, want):
    from types import SimpleNamespace
    from dasp_tpu.bench.device import smi_id
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert smi_id(SimpleNamespace(local_hardware_id=ordinal)) == want
