"""The engine's one device-decoder table and the paths that read it:
tiled pipeline zero-fill under mode masks and flags, sharded decode on
virtual devices, and the repository-wide rule that nothing picks a
code path by accelerator name."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import detex_tpu.convert_device as CD
import detex_tpu.engine as engine
import detex_tpu.formats as F
from detex_tpu.ops.bitops import words_from_bytes
from detex_tpu.texture import Texture
from detex_tpu.utils.blocks import FAMILIES, random_blocks, texture_format

REPO = Path(__file__).resolve().parent.parent

# (mode_mask, flags) that invalidate some blocks of the family: a mode
# mask for the moded formats, the reference's validity flags otherwise.
_VARIANT = {
    "BC1A": (0xFFFFFFFF, F.FLAG_OPAQUE_ONLY),
    "BC2": (0xFFFFFFFF, F.FLAG_ENCODE),
    "BC3": (0xFFFFFFFF, F.FLAG_OPAQUE_ONLY),
    "BPTC": (0x55555555, F.FLAG_NON_OPAQUE_ONLY),
}


def _target(fmt):
    """A non-default target, so invalid blocks zero-fill in a converted
    format, when the device can convert to it."""
    src = F.texture_pixel_format(fmt)
    for dst in (F.BGRA8, F.RGBA8, F.RGBA16):
        if dst != src and CD.path_supported(src, dst):
            return dst
    return src


@pytest.mark.parametrize("family", FAMILIES)
def test_tiled_pipeline_mode_mask_zero_fill(family):
    """decompress_texture_tiled(backend='device') under a mode mask /
    flags that invalidate blocks equals the native host path, whose
    invalid blocks are zero in the target format (texture.c:90-93)."""
    fmt = texture_format(family)
    rng = np.random.default_rng(F.compressed_index(fmt))
    blocks = random_blocks(rng, family, 96)
    tex = Texture.new(fmt, blocks.reshape(-1), 48, 32)
    mask, flags = _VARIANT.get(family, (0x55555555, F.FLAG_ENCODE))
    dst = _target(fmt)
    host = engine.decompress_texture_tiled(tex, dst, mask, flags,
                                           backend="native")
    dev = engine.decompress_texture_tiled(tex, dst, mask, flags,
                                          backend="device")
    assert engine.LAST_BACKEND == "device"
    np.testing.assert_array_equal(host, dev)
    if family in _VARIANT or family.startswith("BPTC"):
        per_block = host.reshape(96, -1)
        assert np.any(np.all(per_block == 0, axis=1)), \
            "variant should zero at least one block"


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_decode_matches_unsharded(family):
    """decode_blocks_sharded over a 4-device 'dp' mesh returns the
    unsharded decode bit for bit, for every family."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("dp",))
    fmt = texture_format(family)
    rng = np.random.default_rng(7 + F.compressed_index(fmt))
    words = words_from_bytes(random_blocks(rng, family, 256))
    pix_s, valid_s = engine.decode_blocks_sharded(fmt, words, mesh)
    pix_u, valid_u = engine.decode_blocks_device(fmt, words)
    np.testing.assert_array_equal(np.asarray(pix_s), np.asarray(pix_u))
    np.testing.assert_array_equal(np.asarray(valid_s), np.asarray(valid_u))


def test_decoder_table_covers_every_family():
    for platform in ("cpu", "gpu"):
        names = {engine.decoder_name(texture_format(f), platform)
                 for f in FAMILIES}
        assert len(names) == len(FAMILIES)
        assert all(n.split(":")[1].startswith("detex_tpu.") for n in names)
    assert engine.decoder_name(F.BPTC) == engine.decoder_name(F.BPTC, "cpu")
    with pytest.raises(ValueError):
        engine.device_decoder(F.RGBA8)


def test_no_code_path_chosen_by_accelerator_name():
    """No module imports the TPU Pallas dialect, branches on a "tpu"
    backend, or falls back to the Pallas interpreter by itself."""
    banned = re.compile("|".join([
        r"pallas import " + "tpu", "plt" + "pu", "use_" + "interpret",
        r"default_backend\(\) *== *[\"']" + "tpu", "DETEX_TEST_" + "TPU",
        "detex_" + "jax_cache"]))
    hits = []
    paths = [*REPO.glob("*.py"), *REPO.glob("*.toml")]
    for sub in ("detex_tpu", "tests", "tools"):
        paths += (REPO / sub).rglob("*.py")
    for path in paths:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if banned.search(line):
                hits.append(f"{path.relative_to(REPO)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)
