"""Generate golden test vectors from the compiled C reference.

Outputs (committed to the repo so the test suite is standalone):
  tests/golden/<FAMILY>.npz   per decoder family:
      corpus_blocks  (N, bs) u8   blocks of the 64x64 corpus texture
      corpus_out     (N, os) u8   reference per-block decode (native fmt)
      corpus_valid   (N,)   bool
      random_blocks  (M, bs) u8   random bitstrings (seeded)
      random_out     (M, os) u8
      random_valid   (M,)   bool
      texture_rgba8 / texture_f32 ...: full-texture linear decode golden
  detex_tpu/data/bptc_tables.npz : BC7/BC6H partition/anchor/weight tables
      read straight out of the reference binary (spec constants as data).

Host-only: needs the C reference's sources (tools/refbind.py), which
the repository does not carry; the committed goldens are its output.

Usage:  python tools/gen_goldens.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

from refbind import Reference, BLOCK_DECODERS  # noqa: E402
from detex_tpu import formats as F  # noqa: E402

REF_SRC = Path("/root/reference")
GOLDEN = REPO / "tests" / "golden"
N_RANDOM = 4096

# Corpus file per family (validate.c:31-57).  BPTC_SIGNED_FLOAT and
# EAC_SIGNED_RG11 have no corpus file in the reference tree (SURVEY.md §2
# item 26) — random vectors only for those.
CORPUS = {
    "BC1": "test-texture-BC1.ktx",
    "BC1A": "test-texture-BC1A.ktx",
    "BC2": "test-texture-BC2.ktx",
    "BC3": "test-texture-BC3.ktx",
    "RGTC1": "test-texture-RGTC1.ktx",
    "SIGNED_RGTC1": "test-texture-SIGNED_RGTC1.ktx",
    "RGTC2": "test-texture-RGTC2.ktx",
    "SIGNED_RGTC2": "test-texture-SIGNED_RGTC2.ktx",
    "BPTC": "test-texture-BPTC.ktx",
    "BPTC_FLOAT": "test-texture-BPTC_FLOAT.ktx",
    "BPTC_SIGNED_FLOAT": None,
    "ETC1": "test-texture-ETC1.ktx",
    "ETC2": "test-texture-ETC2.ktx",
    "ETC2_PUNCHTHROUGH": "test-texture-ETC2_PUNCHTHROUGH.ktx",
    "ETC2_EAC": "test-texture-ETC2_EAC.ktx",
    "EAC_R11": "test-texture-EAC_R11.ktx",
    "EAC_SIGNED_R11": "test-texture-EAC_SIGNED_R11.ktx",
    "EAC_RG11": "test-texture-EAC_RG11.ktx",
    "EAC_SIGNED_RG11": None,
}

# Extra (mode_mask, flags) combos exercised per family beyond the default.
EXTRA_VARIANTS = {
    "BC1A": [(0xFFFFFFFF, F.FLAG_OPAQUE_ONLY),
             (0xFFFFFFFF, F.FLAG_NON_OPAQUE_ONLY)],
    "BC2": [(0xFFFFFFFF, F.FLAG_ENCODE)],
    "BC3": [(0xFFFFFFFF, F.FLAG_ENCODE)],
    "ETC2": [(F.MODE_MASK_ETC_INDIVIDUAL | F.MODE_MASK_ETC_DIFFERENTIAL, 0),
             (F.MODE_MASK_ETC_T | F.MODE_MASK_ETC_H | F.MODE_MASK_ETC_PLANAR,
              0)],
    "ETC2_PUNCHTHROUGH": [(0xFFFFFFFF, F.FLAG_OPAQUE_ONLY),
                          (0xFFFFFFFF, F.FLAG_NON_OPAQUE_ONLY)],
    "BPTC": [(0x0F, 0), (0xF0, 0)],
    "BPTC_FLOAT": [(0x00FF, 0), (0x3F00, 0)],
}


def gen_family(ref: Reference, family: str, rng: np.random.Generator):
    _, bs, os_ = BLOCK_DECODERS[family]
    out = {}

    corpus_file = CORPUS[family]
    if corpus_file is not None:
        fmt, data, w, h = ref.load_texture(str(REF_SRC / corpus_file))
        info = F.BY_NAME[family]
        assert fmt == info.fmt, (family, hex(fmt), hex(info.fmt))
        blocks = data.reshape(-1, bs)
        cout, cvalid = ref.decode_blocks(family, blocks)
        out.update(corpus_blocks=blocks, corpus_out=cout,
                   corpus_valid=cvalid, width=np.int32(w), height=np.int32(h))
        # Full-texture goldens through detexDecompressTextureLinear: native
        # pixel format and an RGBA8 (or FLOAT_RGBX16 for HDR) conversion.
        native_fmt = info.decoded_pixel_format
        out["texture_native"] = ref.decompress_texture_linear(
            info.fmt, data, w, h, native_fmt)
        if not F.is_float(native_fmt) and native_fmt not in (
                F.SIGNED_R16, F.SIGNED_RG16):
            out["texture_rgba8"] = ref.decompress_texture_linear(
                info.fmt, data, w, h, F.RGBA8)

    rblocks = rng.integers(0, 256, size=(N_RANDOM, bs), dtype=np.uint8)
    rout, rvalid = ref.decode_blocks(family, rblocks)
    out.update(random_blocks=rblocks, random_out=rout, random_valid=rvalid)

    for vi, (mask, flags) in enumerate(EXTRA_VARIANTS.get(family, [])):
        vout, vvalid = ref.decode_blocks(family, rblocks, mask, flags)
        out[f"variant{vi}_mask"] = np.uint32(mask)
        out[f"variant{vi}_flags"] = np.uint32(flags)
        out[f"variant{vi}_out"] = vout
        out[f"variant{vi}_valid"] = vvalid
        if corpus_file is not None:
            cv_out, cv_valid = ref.decode_blocks(
                family, out["corpus_blocks"], mask, flags)
            out[f"variant{vi}_corpus_out"] = cv_out
            out[f"variant{vi}_corpus_valid"] = cv_valid

    np.savez_compressed(GOLDEN / f"{family}.npz", **out)
    n_corpus = out.get("corpus_blocks", np.zeros((0,))).shape[0]
    print(f"  {family:20s} corpus={n_corpus:4d} random={N_RANDOM} "
          f"valid={int(rvalid.sum())}")


def gen_bptc_tables(ref: Reference):
    tables = {
        "P2": ref.read_table("detex_bptc_table_P2", 64 * 16, np.uint8)
        .reshape(64, 16),
        "P3": ref.read_table("detex_bptc_table_P3", 64 * 16, np.uint8)
        .reshape(64, 16),
        "anchor2": ref.read_table(
            "detex_bptc_table_anchor_index_second_subset", 64, np.uint8),
        "anchor2of3": ref.read_table(
            "detex_bptc_table_anchor_index_second_subset_of_three", 64,
            np.uint8),
        "anchor3": ref.read_table(
            "detex_bptc_table_anchor_index_third_subset", 64, np.uint8),
        "weight2": ref.read_table("detex_bptc_table_aWeight2", 4, np.uint16),
        "weight3": ref.read_table("detex_bptc_table_aWeight3", 8, np.uint16),
        "weight4": ref.read_table("detex_bptc_table_aWeight4", 16, np.uint16),
    }
    path = REPO / "detex_tpu" / "data" / "bptc_tables.npz"
    np.savez_compressed(path, **tables)
    print(f"  bptc tables -> {path}")


def main():
    GOLDEN.mkdir(parents=True, exist_ok=True)
    ref = Reference()
    gen_bptc_tables(ref)
    rng = np.random.default_rng(20260817)
    for family in BLOCK_DECODERS:
        gen_family(ref, family, rng)
    print("done.")


if __name__ == "__main__":
    main()
