"""The port's readers for the files users have: safetensors checkpoints and
adapters, zstd parquet and list columns, against the packages the JAX
package reads them with, on the CPU.

* ``io/safetensors`` against ``safetensors``: the package's files (every
  dtype, BF16 widened exactly, ``__metadata__``, shards with an index) read
  equal; the port's files load through ``safetensors.numpy`` and
  ``safetensors.torch``; headers that break the format raise.
* ``compat/hf_import`` on safetensors dirs (one file, shards, F16, a dir
  holding both formats) equal to JAX's ``import_params``; BF16 equal to
  ``safetensors.torch``. PEFT dirs cross between the packages.
* ``io/zstd`` against ``zstandard``: levels -5 to 22 on random, constant,
  multi-block, float32, table-text and RLE-literal inputs (every literals
  type and table mode reached), with and without checksum and content size,
  concatenated and skippable frames, the empty input; a flipped checksum,
  a dictionary ID and a corrupt stream raise. ``xxh64`` against ``xxhash``.
* ``io/parquet`` on zstd files equal to ``pandas.read_parquet``: the
  committed shards of JAX's ``convert_to_shards`` and tables of JAX's
  ``tokenize`` (``tests/format_fixtures``, written by
  ``tests/torch_format_fixtures.py``, checked against its seed), list
  columns with empty, null and null-element cells in pages v1 and v2, the
  legacy 2-level layout; the port's list columns read back by pandas.
* In a fresh interpreter with jax, the JAX package, safetensors, zstandard,
  pandas and pyarrow unimportable, every route these readers serve.
"""

import json
import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
import xxhash
import zstandard
from safetensors import safe_open
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from plantcaduceus_tpu.compat import hf_import as jhf
from plantcaduceus_tpu.compat import peft_adapter as jpeft
from plantcaduceus_tpu.io.tokenizer import DnaTokenizer as JaxTokenizer
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu.train import streaming as jstreaming
from plantcaduceus_tpu_torch.compat import hf_import, peft_adapter
from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
from plantcaduceus_tpu_torch.io import parquet, zstd
from plantcaduceus_tpu_torch.io import safetensors as st
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.caduceus import init_params
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train import streaming
from tests import torch_format_fixtures as fx
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
TINY = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)
RANK = 4


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
          "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}


def _tensors(dtype):
    a = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 5)) * 60)
    return {"w": a.to(dtype), "scalar": torch.tensor(7.0).to(dtype),
            "empty": torch.zeros((0, 4), dtype=dtype), "v": a[0].clone().to(dtype)}


@pytest.mark.parametrize("name", list(DTYPES))
def test_safetensors_reads_the_package_files(tmp_path, name):
    path = tmp_path / "x.safetensors"
    torch_save_file(_tensors(DTYPES[name]), str(path), metadata={"format": "pt"})
    got, want = st.load_file(path), torch_load_file(str(path))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = (w.float() if name == "BF16" else w).numpy()  # BF16 widens to float32 exactly
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    if name != "BF16":  # numpy has no bfloat16
        for k, w in np_load_file(str(path)).items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_port_files_load_in_the_package(tmp_path):
    rng = np.random.default_rng(4)
    arrays = {f"{np.dtype(t).name}": (rng.standard_normal((2, 3)) * 50).astype(t)
              for t in (np.float64, np.float32, np.float16, np.int64, np.int32, np.int16,
                        np.int8, np.uint8, np.bool_)}
    arrays["scalar"] = np.float32(1.5)
    st.save_file(arrays, tmp_path / "a.safetensors")
    raw = (tmp_path / "a.safetensors").read_bytes()
    assert struct.unpack("<Q", raw[:8])[0] % 8 == 0
    got = np_load_file(str(tmp_path / "a.safetensors"))
    assert got.keys() == arrays.keys()
    for k, v in arrays.items():
        assert got[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with safe_open(str(tmp_path / "a.safetensors"), "np") as f:
        assert f.metadata() is None and sorted(f.keys()) == sorted(arrays)
    ours = st.load_file(tmp_path / "a.safetensors")
    ours["float32"][0, 0] = 123.0  # copy-on-write: the file keeps its bytes
    assert (tmp_path / "a.safetensors").read_bytes() == raw
    bf = torch.randn(4, 3).to(torch.bfloat16)
    st.save_file({"bf": bf, "f": torch.ones(2)}, tmp_path / "b.safetensors")
    got = torch_load_file(str(tmp_path / "b.safetensors"))
    assert got["bf"].dtype == torch.bfloat16 and torch.equal(got["bf"], bf)
    np.testing.assert_array_equal(st.load_file(tmp_path / "b.safetensors")["bf"],
                                  bf.float().numpy())


def test_sharded_checkpoints(tmp_path):
    rng = np.random.default_rng(5)
    tensors = {f"layers.{i}.w": rng.standard_normal((i + 2, 3)).astype(np.float32)
               for i in range(5)}
    # the package's shards and index, as save_pretrained lays them out
    names = {k: f"model-0000{1 + i // 3}-of-00002.safetensors" for i, k in enumerate(tensors)}
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for fname in set(names.values()):
        np_save_file({k: v for k, v in tensors.items() if names[k] == fname}, str(pkg / fname))
    (pkg / st.INDEX_NAME).write_text(json.dumps({"metadata": {"total_size": 0},
                                                 "weight_map": names}))
    _assert_trees_equal(st.load_dir(pkg), tensors)
    # the port's shards: each a package-readable file, the index exact
    st.save_sharded(tensors, tmp_path / "port", 3)
    index = json.loads((tmp_path / "port" / st.INDEX_NAME).read_text())
    assert sorted(set(index["weight_map"].values())) == [
        f"model-0000{i}-of-00003.safetensors" for i in (1, 2, 3)]
    merged = {}
    for fname in set(index["weight_map"].values()):
        part = np_load_file(str(tmp_path / "port" / fname))
        assert all(index["weight_map"][k] == fname for k in part)
        merged.update(part)
    _assert_trees_equal(merged, tensors)
    assert index["metadata"]["total_size"] == sum(v.nbytes for v in tensors.values())
    # a stale model.safetensors beside the shards, and an index that no
    # longer matches them: merged in sorted file order (model.safetensors
    # sorts after the shards, so its tensor is taken), the index not read,
    # as JAX's load_state_dict does
    names["layers.0.w"] = "model-00002-of-00002.safetensors"
    (pkg / st.INDEX_NAME).write_text(json.dumps({"weight_map": names}))
    np_save_file({"layers.0.w": np.zeros((2, 3), np.float32),
                  "stale.only": np.ones(2, np.float32)}, str(pkg / "model.safetensors"))
    got = st.load_dir(pkg)
    want = jhf.load_state_dict(pkg)
    _assert_trees_equal(got, want)
    assert not got["layers.0.w"].any() and got["stale.only"].tolist() == [1.0, 1.0]


def _raw_file(path, header, data: bytes, length=None):
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw) if length is None else length) + raw + data)


GOOD = {"a": {"dtype": "F32", "shape": [2, 3], "data_offsets": [0, 24]},
        "b": {"dtype": "I64", "shape": [4], "data_offsets": [24, 56]}}


@pytest.mark.parametrize("fault, match", [
    ("gap", "starts at 32, not at 24"),
    ("overlap", "starts at 16, not at 24"),
    ("span", "not the 40 bytes"),
    ("past_end", "end at byte"),
    ("trailing", "end at byte"),
    ("huge_header", "limit is 100000000"),
    ("header_past_end", "runs past the end"),
    ("dtype", "'F8'"),
    ("not_json", "not JSON"),
    ("no_offsets", "lacks dtype, shape"),
    ("metadata", "__metadata__ must map strings to strings"),
])
def test_safetensors_bad_headers_raise(tmp_path, fault, match):
    header = json.loads(json.dumps(GOOD))
    data, length = bytes(56), None
    if fault == "gap":
        header["b"]["data_offsets"] = [32, 64]
        data = bytes(64)
    elif fault == "overlap":
        header["b"]["data_offsets"] = [16, 48]
    elif fault == "span":
        header["b"]["shape"] = [5]
    elif fault == "past_end":
        data = bytes(40)
    elif fault == "trailing":
        data = bytes(64)
    elif fault == "huge_header":
        length = 100_000_000
    elif fault == "header_past_end":
        length = 4096
    elif fault == "dtype":
        header["a"]["dtype"] = "F8"
    elif fault == "no_offsets":
        del header["a"]["data_offsets"]
    elif fault == "metadata":
        header["__metadata__"] = {"format": 1}
    path = tmp_path / "bad.safetensors"
    _raw_file(path, header, data, length)
    if fault == "not_json":
        path.write_bytes(struct.pack("<Q", 8) + b"{not js}")
    with pytest.raises(ValueError, match=match):
        st.load_file(path)


# ---------------------------------------------------------------------------
# checkpoints and adapters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_bin(tmp_path_factory):
    """An untied tiny checkpoint (config.json + pytorch_model.bin)."""
    cfg = CaduceusConfig(**TINY, bidirectional_weight_tie=False)
    d = tmp_path_factory.mktemp("ckpt") / "bin"
    export_hf_dir(d, init_params(cfg, seed=11), cfg)
    return d


def _state_dict(d):
    """The .bin's tensors, contiguous as ``safetensors.torch`` wants them."""
    return {k: v.contiguous() for k, v in
            torch.load(d / "pytorch_model.bin", weights_only=True).items()}


def _with_config(src, dst):
    dst.mkdir(parents=True)
    (dst / "config.json").write_text((src / "config.json").read_text())
    return dst


@pytest.mark.parametrize("form", ["single", "sharded", "f16", "both"])
def test_hf_import_of_safetensors_matches_jax(tmp_path, tiny_bin, form):
    sd = _state_dict(tiny_bin)
    d = _with_config(tiny_bin, tmp_path / form)
    if form == "f16":
        sd = {k: v.half() for k, v in sd.items()}
    if form == "sharded":
        st.save_sharded(sd, d, 2)
    else:
        torch_save_file(sd, str(d / "model.safetensors"))
    if form == "both":  # a .bin beside it that neither package may take
        torch.save({k: torch.zeros_like(v) for k, v in sd.items()}, d / "pytorch_model.bin")
    got, cfg = hf_import.import_params(d)
    want, _ = jhf.import_params(d)
    _assert_trees_equal(got, want)
    if form in ("single", "both"):
        _assert_trees_equal(got, hf_import.import_params(tiny_bin)[0])


def test_hf_import_of_bf16_matches_safetensors_torch(tmp_path, tiny_bin):
    sd = _state_dict(tiny_bin)
    d = _with_config(tiny_bin, tmp_path / "bf16")
    torch_save_file({k: v.to(torch.bfloat16) for k, v in sd.items()},
                    str(d / "model.safetensors"))
    want = {k: v.float().numpy() for k, v in torch_load_file(str(d / "model.safetensors")).items()}
    _assert_trees_equal(hf_import.load_state_dict(d), want)
    # JAX's loader reads no BF16 here (numpy has no bfloat16): the same
    # values as F32 safetensors
    f32 = _with_config(tiny_bin, tmp_path / "f32")
    np_save_file(want, str(f32 / "model.safetensors"))
    _assert_trees_equal(hf_import.import_params(d)[0], jhf.import_params(f32)[0])


def _peft_sd(rng, cfg):
    """A PEFT state dict for a tied model: in_proj, x_proj and out_proj
    adapters and a classification head."""
    d, di, R, N = cfg.d_model, cfg.d_inner, cfg.dt_rank, cfg.d_state
    sd = {}
    for i in range(cfg.n_layer):
        for name, (n_in, n_out) in (("in_proj", (d, 2 * di)), ("x_proj", (di, R + 2 * N)),
                                    ("out_proj", (di, d))):
            k = f"base_model.model.backbone.layers.{i}.mixer.{name}"
            sd[f"{k}.lora_A.weight"] = rng.standard_normal((RANK, n_in)).astype(np.float32)
            sd[f"{k}.lora_B.weight"] = rng.standard_normal((n_out, RANK)).astype(np.float32)
    sd["base_model.model.score.modules_to_save.weight"] = rng.standard_normal(
        (2, d)).astype(np.float32)
    sd["base_model.model.score.modules_to_save.bias"] = np.zeros(2, np.float32)
    return sd


def test_peft_dirs_cross_between_packages(tmp_path):
    """A dir the JAX package exported (through ``safetensors``) imports in
    the port as in JAX; the port's export (its own writer) imports in JAX
    as in the port."""
    cfg, jcfg = CaduceusConfig(**TINY), JaxConfig(**TINY)
    src = tmp_path / "src"
    src.mkdir()
    np_save_file(_peft_sd(np.random.default_rng(6), cfg), str(src / "adapter_model.safetensors"))
    (src / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA", "task_type": "SEQ_CLS", "r": RANK, "lora_alpha": 8.0,
        "lora_dropout": 0.0, "target_modules": ["in_proj", "x_proj", "out_proj"],
        "base_model_name_or_path": "base"}))
    jax_import = jpeft.import_peft_adapter(src, jcfg)
    jpeft.export_peft_adapter(tmp_path / "jax", *jax_import[:2], jcfg, *jax_import[2:])
    got = peft_adapter.import_peft_adapter(tmp_path / "jax", cfg)
    _assert_trees_equal(got[:2], jax_import[:2])
    peft_adapter.export_peft_adapter(tmp_path / "port", *got[:2], cfg, *got[2:])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "adapter_config.json", "adapter_model.safetensors"]
    back = jpeft.import_peft_adapter(tmp_path / "port", jcfg)
    _assert_trees_equal(back[:2], got[:2])
    assert tuple(back[2]) == tuple(got[2]) and back[3:] == got[3:]


# ---------------------------------------------------------------------------
# zstd
# ---------------------------------------------------------------------------


def _table_text(rng, nbytes):
    """Rows of an evaluation table's kind: names, positions, words over a
    wide alphabet, floats."""
    chars = list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-.,;:!?()"
                 "[]{}<>/|@#$%^&*+=~'")
    words = ["".join(rng.choice(chars, rng.integers(2, 10))) for _ in range(600)]
    rows, size = [], 0
    while size < nbytes:
        rows.append(f"chr{rng.integers(1, 11)}\t{rng.integers(1, 10**8)}\t"
                    f"{' '.join(rng.choice(words, rng.integers(1, 6)))}\t"
                    f"{rng.standard_normal():.6g}\t{rng.random():.4f}\n")
        size += len(rows[-1])
    return "".join(rows).encode()


@pytest.fixture(scope="module")
def zstd_inputs():
    rng = np.random.default_rng(8)
    genome = fx._genome(np.random.default_rng(9), 140 * 1024).encode()  # > one 128 KiB block
    # one random 128 KiB block, then a block of its pieces joined by a byte
    # it lacks: that block's literals are all that byte
    head = rng.integers(0, 255, 128 * 1024, dtype=np.uint8).tobytes()
    pieces = b"".join(head[i:i + 64] + b"\xff" for i in rng.integers(0, len(head) - 64, 800))
    return {"empty": b"", "random": rng.bytes(3000), "constant": b"A" * 5000,
            "multiblock": genome,
            "float32": np.round(rng.standard_normal(16384) * 100, 1).astype("<f4").tobytes(),
            "text": _table_text(rng, 200 * 1024),
            "four_symbols": rng.integers(0, 4, 20000, dtype=np.uint8).tobytes(),
            "rle_literals": head + pieces}


def _reference(frame: bytes) -> bytes:
    return zstandard.ZstdDecompressor().decompressobj().decompress(frame)


@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_zstd_decodes_every_frame_as_zstandard(zstd_inputs, level):
    for name, data in zstd_inputs.items():
        for checksum, size in ((True, True), (False, False)):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=size).compress(data)
            assert zstd.decompress(frame) == _reference(frame) == data, (name, checksum, size)


def test_zstd_inputs_reach_every_literal_and_table_mode(zstd_inputs, monkeypatch):
    """The inputs above, at the levels named here, make zstandard use every
    literals type (raw, RLE, Huffman, treeless), every sequence table mode
    (predefined, RLE, FSE, repeat), direct and FSE-coded Huffman weights,
    FSE weights for all 255 symbols before the implied last, and codes of
    the 11-bit limit; each frame decodes equal."""
    seen = {"literals": set(), "modes": set(), "weights": set(), "n_weights": 0, "bits": 0}
    literals, seq_table = zstd._literals, zstd._seq_table
    huffman_weights, huffman_table = zstd._huffman_weights, zstd._huffman_table

    def spy_literals(data, pos, end, fr):
        seen["literals"].add(data[pos] & 3)
        return literals(data, pos, end, fr)

    def spy_seq_table(mode, which, *rest):
        seen["modes"].add(mode)
        return seq_table(mode, which, *rest)

    def spy_weights(data, pos, end):
        weights, used = huffman_weights(data, pos, end)
        kind = "fse" if data[pos] < 128 else "direct"
        seen["weights"].add(kind)
        if kind == "fse":
            seen["n_weights"] = max(seen["n_weights"], len(weights))
        return weights, used

    def spy_table(weights):
        table = huffman_table(weights)
        seen["bits"] = max(seen["bits"], table[2])
        return table

    monkeypatch.setattr(zstd, "_literals", spy_literals)
    monkeypatch.setattr(zstd, "_seq_table", spy_seq_table)
    monkeypatch.setattr(zstd, "_huffman_weights", spy_weights)
    monkeypatch.setattr(zstd, "_huffman_table", spy_table)
    for name, level in (("constant", 3), ("four_symbols", 1), ("float32", 3),
                        ("text", 1), ("multiblock", 9), ("rle_literals", 19)):
        frame = zstandard.ZstdCompressor(level=level).compress(zstd_inputs[name])
        assert zstd.decompress(frame) == zstd_inputs[name], (name, level)
    assert seen == {"literals": {0, 1, 2, 3}, "modes": {0, 1, 2, 3},
                    "weights": {"direct", "fse"}, "n_weights": 255, "bits": 11}


def test_zstd_concatenated_and_skippable_frames(zstd_inputs):
    a, b = zstd_inputs["random"], zstd_inputs["multiblock"][:20000]
    skippable = struct.pack("<II", 0x184D2A5A, 5) + b"meta!"
    stream = (skippable + zstandard.compress(a, 3) + skippable + zstandard.compress(b, 19)
              + zstandard.compress(b""))
    assert zstd.decompress(stream) == a + b


def test_zstd_faults_raise(zstd_inputs):
    data = zstd_inputs["multiblock"][:30000]
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    frame[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum mismatch"):
        zstd.decompress(bytes(frame))
    samples = [data[i:i + 300] for i in range(0, 30000, 150)]
    dictionary = zstandard.train_dictionary(2048, samples)
    with_dict = zstandard.ZstdCompressor(dict_data=dictionary).compress(data)
    with pytest.raises(ValueError, match=f"dictionary {dictionary.dict_id()}"):
        zstd.decompress(with_dict)
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(ValueError, match="corrupt zstd data"):
        zstd.decompress(good[:len(good) // 2])
    corrupt = bytearray(good)
    corrupt[len(good) // 2] ^= 0xFF
    corrupt[len(good) // 3] ^= 0x0F
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(bytes(corrupt))
    reserved = bytearray(good)
    reserved[4] |= 0x08
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(reserved))
    with pytest.raises(ValueError, match="empty input"):
        zstd.decompress(b"")


def test_xxh64_matches_xxhash():
    rng = np.random.default_rng(10)
    for n in (0, 1, 3, 4, 7, 8, 12, 31, 32, 33, 63, 64, 100, 1001):
        data = rng.bytes(n)
        assert zstd.xxh64(data) == xxhash.xxh64_intdigest(data), n


# ---------------------------------------------------------------------------
# parquet
# ---------------------------------------------------------------------------


def _assert_cell(got, want, where):
    if want is None:
        assert got is None, where
        return
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
    assert len(got) == len(want), where
    for a, b in zip(got, want):
        assert (a is None and b is None) or (a != a and b != b) or a == b, (where, got, want)


def _assert_reads_as_pandas(path, columns=None):
    got = parquet.read_parquet(path, columns)
    want = pd.read_parquet(path, columns=columns)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype == object:
            assert len(got[c]) == len(w)
            for i, (g, x) in enumerate(zip(got[c], w)):
                if isinstance(x, np.ndarray) or x is None:
                    _assert_cell(g, x, (path.name, c, i))
                else:
                    assert g == x, (path.name, c, i)
        else:
            assert got[c].dtype == w.dtype, c
            np.testing.assert_array_equal(got[c], w)
    return got


FIXTURE_FILES = ["shards/shard_00000.parquet", "shards/shard_00001.parquet",
                 "lora_cls.parquet", "lora_multi.parquet"]


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_jax_zstd_files_read_as_pandas(name):
    path = fx.FIXTURES / name
    assert pq.ParquetFile(path).metadata.row_group(0).column(0).compression == "ZSTD"
    _assert_reads_as_pandas(path)


def test_committed_fixtures_are_what_their_seed_gives():
    seqs = [s for i in range(fx.SHARDS)
            for s in pd.read_parquet(fx.FIXTURES / f"shards/shard_{i:05d}.parquet")["seq"]]
    assert seqs == fx.shard_sequences()
    tok = JaxTokenizer()
    for task, name in (("classification", "lora_cls"), ("multi_label", "lora_multi")):
        df = pd.read_parquet(fx.FIXTURES / f"{name}.parquet")
        want_seqs, labels = fx.lora_rows(task)
        np.testing.assert_array_equal(np.stack(df["input_ids"].to_numpy()),
                                      tok.encode_batch(want_seqs))
        if task == "classification":
            assert df["label"].tolist() == labels
        else:
            assert [list(v) for v in df["labels"]] == [[int(c) for c in y] for y in labels]


def test_zstd_shards_stream_as_in_jax(tmp_path):
    """The port's stream over JAX's committed zstd shards gives JAX's
    batches byte for byte; a fresh JAX conversion reads as pandas."""
    args = dict(window=fx.L, seed=3, shuffle_buffer=64)
    ours = streaming.StreamingPretrainDataset(fx.FIXTURES / "shards", DnaTokenizer(), 8,
                                              **args).iter_from(5)
    theirs = jstreaming.StreamingPretrainDataset(fx.FIXTURES / "shards", JaxTokenizer(), 8,
                                                 **args).iter_from(5)
    for _ in range(6):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    jstreaming.convert_to_shards(fx.shard_sequences()[:48], tmp_path / "s", shard_size=16)
    for f in sorted((tmp_path / "s").iterdir()):
        _assert_reads_as_pandas(f)


def _list_table(n):
    base = [[1, None, 3], None, [], [4, 5], [6]]
    return pa.table({
        "i32": pa.array([[7, 8], [], None, [9], [10, 11, 12]] * (n // 5), pa.list_(pa.int32())),
        "i64": pa.array(base * (n // 5), pa.list_(pa.int64())),
        "f64": pa.array([[0.5, None], [], None, [1.5], [2.0]] * (n // 5), pa.list_(pa.float64())),
        "f32": pa.array([[0.25], [], None, [1.0, 2.0], []] * (n // 5), pa.list_(pa.float32())),
        "txt": pa.array([["a", None], ["bc"], None, [], ["d"]] * (n // 5),
                        pa.list_(pa.string())),
        "flag": pa.array([[True, None], [False], None, [], [True]] * (n // 5),
                         pa.list_(pa.bool_())),
        "label": pa.array(list(range(n)), pa.int64()),
    })


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False])
def test_list_columns_read_as_pandas(tmp_path, version, dictionary):
    path = tmp_path / "lists.parquet"
    pq.write_table(_list_table(400), path, compression="zstd", data_page_version=version,
                   use_dictionary=dictionary, data_page_size=512, row_group_size=150)
    assert pq.ParquetFile(path).metadata.num_row_groups == 3
    got = _assert_reads_as_pandas(path)
    assert got["i32"][0].dtype == np.int32 and got["i64"][0].dtype == np.float64


def test_legacy_two_level_lists_read_as_pandas(tmp_path):
    """``optional group ids (LIST) { repeated int32 array; }``, which older
    writers emit: definition level 0 a null list, 1 an empty one, 2 a value."""
    cells = [[3, 4], [], None, [5]]
    lengths = np.array([-1 if c is None else len(c) for c in cells])
    entries = np.maximum(lengths, 1)
    rep = np.ones(entries.sum(), np.uint8)
    rep[np.cumsum(entries) - entries] = 0
    dfn = np.repeat(np.where(lengths < 0, 0, np.where(lengths == 0, 1, 2)), entries)
    values = np.array([v for c in cells if c for v in c], "<i4").tobytes()
    raw = parquet._rle_runs(rep) + parquet._rle_runs(dfn.astype(np.uint8)) + values
    head = parquet._Writer()
    head.struct([(1, "i32", parquet.DATA_PAGE), (2, "i32", len(raw)), (3, "i32", len(raw)),
                 (5, "struct", [(1, "i32", len(rep)), (2, "i32", parquet.PLAIN),
                                (3, "i32", parquet.RLE), (4, "i32", parquet.RLE)])])
    body = bytearray(parquet.MAGIC) + head.out + raw
    meta = parquet._Writer()
    meta.struct([
        (1, "i32", 1),
        (2, "list:struct", [[(4, "bin", "schema"), (5, "i32", 1)],
                            [(3, "i32", parquet.OPTIONAL), (4, "bin", "ids"), (5, "i32", 1),
                             (6, "i32", parquet.LIST)],
                            [(1, "i32", parquet.INT32), (3, "i32", parquet.REPEATED),
                             (4, "bin", "array")]]),
        (3, "i64", len(cells)),
        (4, "list:struct", [[(1, "list:struct", [[
            (2, "i64", 4), (3, "struct", [
                (1, "i32", parquet.INT32), (2, "list:i32", [parquet.PLAIN, parquet.RLE]),
                (3, "list:bin", ["ids", "array"]), (4, "i32", parquet.UNCOMPRESSED),
                (5, "i64", len(rep)), (6, "i64", len(body) - 4), (7, "i64", len(body) - 4),
                (9, "i64", 4)])]]), (2, "i64", len(body) - 4), (3, "i64", len(cells))]])])
    body += meta.out + struct.pack("<I", len(meta.out)) + parquet.MAGIC
    (tmp_path / "legacy.parquet").write_bytes(bytes(body))
    got = _assert_reads_as_pandas(tmp_path / "legacy.parquet")
    assert [None if c is None else c.tolist() for c in got["ids"]] == cells


def test_port_list_columns_read_back_by_pandas(tmp_path):
    ids = np.random.default_rng(12).integers(0, 16, (6, 10)).astype(np.int32)
    cols = {"input_ids": ids, "labels": [[1, 0, 1], [], None, [0], [1, 1], [0, 0, 0]],
            "scores": [np.array([0.5, 1.5]), [2.5], [], None, [1.0], [3.0]],
            "label": [0, 1, 0, 1, 1, 0]}
    path = tmp_path / "port.parquet"
    parquet.write_parquet(path, cols)
    schema = pq.read_schema(path)
    assert [str(schema.field(c).type) for c in cols] == [
        "list<element: int32>", "list<element: int64>", "list<element: double>", "int64"]
    _assert_reads_as_pandas(path)
    df = pd.read_parquet(path)
    np.testing.assert_array_equal(np.stack(df["input_ids"].to_numpy()), ids)
    assert [None if v is None else v.tolist() for v in df["labels"]] == cols["labels"]


# ---------------------------------------------------------------------------
# every route, on a host without the packages
# ---------------------------------------------------------------------------

BLOCKED = ("jax", "jaxlib", "plantcaduceus_tpu", "safetensors", "zstandard", "pandas", "pyarrow")

ROUTES = """
import json, sys
from pathlib import Path
for name in {blocked}:
    sys.modules[name] = None  # importing it now raises ImportError
work, fixtures = Path(sys.argv[1]), Path(sys.argv[2])
from plantcaduceus_tpu_torch.compat import hf_import, peft_adapter
from plantcaduceus_tpu_torch.cli import lora_fine_tune as ft, zero_shot_eval
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.train.streaming import StreamingPretrainDataset

model, cfg = hf_import.import_model(work / "ckpt")                     # safetensors import
ad, head, cfg_l, task, base = peft_adapter.import_peft_adapter(work / "peft", cfg)
peft_adapter.export_peft_adapter(work / "peft_out", ad, head, cfg, cfg_l, task, base)
assert (work / "peft_out" / "adapter_model.safetensors").exists()
peft_adapter.import_peft_adapter(work / "peft_out", cfg)
ft.main(["tokenize", "--data-dir", str(work / "t.tsv"), "--output-path",
         str(work / "t.parquet"), "--sequence-length", "64", "--task-type", "multi_label"])
ids, labels = ft._load_data(work / "t.parquet")
assert ids.shape == (5, 64) and labels.shape == (5, 3)
for name in ("lora_cls", "lora_multi"):
    ids, labels = ft._load_data(fixtures / (name + ".parquet"))
    assert ids.shape == (64, 512) and len(labels) == 64
batch = next(StreamingPretrainDataset(fixtures / "shards", DnaTokenizer(), 4,
                                      window=512).iter_from(0))
assert batch["input_ids"].shape == (4, 512)
zero_shot_eval.main(["evo_cons", "--repo-id", str(work / "evo.parquet"), "--model",
                     str(work / "ckpt"), "--device", "cpu", "--token-idx", "31",
                     "--no-progress", "--metrics-json", str(work / "m.json")])
assert json.loads((work / "m.json").read_text())
loaded = sorted(m for m, v in sys.modules.items()
                if v is not None and m.split(".")[0] in {blocked})
assert not loaded, loaded
print("every route ran")
"""


def test_routes_run_without_the_packages(tmp_path, tiny_bin):
    sd = _state_dict(tiny_bin)
    st.save_sharded(sd, _with_config(tiny_bin, tmp_path / "ckpt"), 2)
    cfg = CaduceusConfig(**TINY, bidirectional_weight_tie=False)
    peft = tmp_path / "peft"
    peft.mkdir()
    np_save_file(_peft_sd(np.random.default_rng(13), cfg), str(peft / "adapter_model.safetensors"))
    (peft / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA", "task_type": "SEQ_CLS", "r": RANK, "lora_alpha": 8.0,
        "target_modules": ["in_proj", "x_proj", "out_proj"]}))
    rng = np.random.default_rng(14)
    seqs = ["".join(rng.choice(list("ACGT"), 64)) for _ in range(8)]
    (tmp_path / "t.tsv").write_text("sequence\tlabel\n" + "".join(
        f"{s}\t1{i % 2}{i % 3 % 2}\n" for i, s in enumerate(seqs[:5])))
    pd.DataFrame({"sequence": seqs, "label": [0, 1] * 4}).to_parquet(
        tmp_path / "evo.parquet", compression="zstd")
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH")
           if k in os.environ}
    res = subprocess.run(
        [sys.executable, "-c", ROUTES.format(blocked=BLOCKED), str(tmp_path), str(fx.FIXTURES)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(env, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("every route ran")
