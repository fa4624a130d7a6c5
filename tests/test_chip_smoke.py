"""chip_smoke.py's own logic, on the CPU: it refuses a machine without
a GPU, compares decodes bit for bit, picks its phases, and the compile
cache resolves as documented.  The phases themselves run on the card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import chip_smoke
from detex_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_device_check_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.require_gpu(jax.devices())
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.require_gpu([])


def test_main_exits_nonzero_without_gpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo:
    the script exits non-zero and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_compare_decode_catches_one_flipped_bit():
    rng = np.random.default_rng(0)
    want = rng.integers(0, 256, (64, 16), np.uint8)
    valid = np.ones(64, bool)
    valid[5] = False
    got = want.copy()
    got[5] ^= 0xFF                    # invalid block: not compared
    chip_smoke.compare_decode("t", got, valid, want, valid)
    got[17, 3] ^= 0x10
    with pytest.raises(chip_smoke.SmokeFailure, match="1 of 63"):
        chip_smoke.compare_decode("t", got, valid, want, valid)
    with pytest.raises(chip_smoke.SmokeFailure, match="valid mask"):
        chip_smoke.compare_decode("t", want, ~valid, want, valid)


def test_four_cards_selects_only_its_phases():
    assert chip_smoke.phases(True) == ("four_cards",)
    assert chip_smoke.phases(False) == ("decode", "texture", "control",
                                        "train")
    assert set(chip_smoke.PHASES) == {"four_cards", "decode", "texture",
                                      "control", "train"}


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == tmp_path
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.use_compile_cache() == tmp_path
    assert jax.config.jax_compilation_cache_dir == before   # set nothing


def test_compile_cache_dir_defaults_into_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == REPO / ".jax_cache"
    before = jax.config.jax_compilation_cache_dir
    try:
        compile_cache.use_compile_cache()
        assert jax.config.jax_compilation_cache_dir == \
            str(REPO / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_result_line_shape(monkeypatch, capsys):
    """With the device check and phases stubbed, the last stdout line
    is the one JSON object the contract names."""
    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(chip_smoke, "require_gpu", lambda devs: Dev)
    from detex_tpu.utils import metrics
    monkeypatch.setattr(metrics, "nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    ran = []
    monkeypatch.setattr(chip_smoke, "PHASES",
                        {k: (lambda seed, k=k: ran.append(k))
                         for k in chip_smoke.PHASES})
    assert chip_smoke.main(["--four-cards"]) == 0
    assert ran == ["four_cards"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": len(jax.devices())}}
