"""The port's parquet reader and writer, sharded streaming and the trainer's
shard, parquet and profile routes, against pyarrow and the JAX package, on
the CPU.

* ``io/parquet``: files pyarrow writes (all six physical types, nulls, four
  row groups; with a dictionary, with its fallback to PLAIN pages, and
  without; data pages v1 and v2; uncompressed, snappy and gzip) read equal
  to ``pyarrow.parquet.read_table``; snappy's overlapping copies; the
  port's files read back equal by pyarrow and pandas; zstd frames with a
  dictionary, structs, maps and lists of lists refused by name.
* ``train/streaming``: over one shard directory written by the port's
  ``convert_to_shards``, JAX's ``StreamingPretrainDataset`` and the port's
  give byte-equal batches from step 0, from a resume step and across epoch
  boundaries; ``eval_batches``; ``_host_shards`` with 2 processes; FASTA and
  TSV shards; ``concat_chunks``. ``sequence_source`` on a parquet table.
* ``cli/pretrain``: a ``shards:`` run with ``--eval-shards`` and
  ``--profile-dir`` (a trace of steps 10-12), resumed at step 7 to the same
  bits.
* ``utils/profiling``: ``trace`` writes a Chrome trace of its block;
  ``device_memory_stats`` is empty without a card.
"""

import json

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from plantcaduceus_tpu.io.tokenizer import DnaTokenizer as JaxTokenizer
from plantcaduceus_tpu.train import streaming as jstreaming
from plantcaduceus_tpu_torch.io import parquet
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.train import data as data_lib
from plantcaduceus_tpu_torch.train import streaming
from tests.torch_threads import one_torch_thread  # noqa: F401

N_ROWS = 1200

# ---------------------------------------------------------------------------
# io/parquet
# ---------------------------------------------------------------------------


def _table(seed=0, n=N_ROWS):
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGTacgt"), 40)) for _ in range(n)]
    return pa.table({
        "seq": seqs,
        "seq_nulls": [None if i % 7 == 0 else s for i, s in enumerate(seqs)],
        "label": pa.array([["aa", "bb", "cc", None][i % 4] for i in range(n)]),
        "repeat": ["ACGT" * int(rng.integers(20, 40)) for _ in range(n)],   # snappy copies
        "i64": pa.array([None if i % 5 == 0 else int(v)
                         for i, v in enumerate(rng.integers(-10**12, 10**12, n))], pa.int64()),
        "i32": pa.array(rng.integers(-1000, 1000, n).astype(np.int32)),
        "f32": pa.array([None if i % 3 == 0 else float(v)
                         for i, v in enumerate(rng.standard_normal(n))], pa.float32()),
        "f64": pa.array(rng.standard_normal(n)),
        "flag": pa.array([None if i % 4 == 0 else bool(v)
                          for i, v in enumerate(rng.integers(0, 2, n))]),
        "flag_req": pa.array(rng.integers(0, 2, n).astype(bool)),
    })


def _as_pylist(col):
    """The port's column as pyarrow's ``to_pydict`` gives it (NaN -> None)."""
    vals = col.tolist() if isinstance(col, np.ndarray) else list(col)
    return [None if isinstance(v, float) and np.isnan(v) else v for v in vals]


def _assert_equal_to_pyarrow(path, got):
    want = pq.read_table(path).to_pydict()
    assert list(got) == list(want)
    for name, values in want.items():
        g = _as_pylist(got[name])
        if name == "f32":  # pyarrow widens float32 to a Python float
            values = [None if v is None else float(np.float32(v)) for v in values]
            g = [None if v is None else float(np.float32(v)) for v in g]
        assert g == values, name


DICT_MODES = {
    "dictionary": dict(use_dictionary=True),
    "fallback": dict(use_dictionary=True, dictionary_pagesize_limit=2000, data_page_size=4000),
    "plain": dict(use_dictionary=False),
}


@pytest.mark.parametrize("mode", list(DICT_MODES))
@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("codec", ["none", "snappy", "gzip"])
def test_read_parquet_matches_pyarrow(tmp_path, codec, version, mode):
    path = tmp_path / "t.parquet"
    pq.write_table(_table(), path, compression=codec, data_page_version=version,
                   row_group_size=N_ROWS // 4, **DICT_MODES[mode])
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == 4
    if mode == "fallback":   # dictionary pages, then PLAIN pages, in one chunk
        enc = meta.row_group(0).column(0).encodings
        assert "PLAIN" in enc and "RLE_DICTIONARY" in enc, enc
    got = parquet.read_parquet(path)
    _assert_equal_to_pyarrow(path, got)
    assert got["i32"].dtype == np.int32 and got["f64"].dtype == np.float64
    assert got["i64"].dtype == np.float64  # an integer column with nulls, as pandas gives it
    assert got["flag_req"].dtype == bool
    assert parquet.read_parquet(path, ["f64", "seq"]).keys() == {"f64", "seq"}


def test_snappy_overlapping_copies():
    data = b"a" * 1000 + b"ACGT" * 300 + bytes(range(256)) * 3
    comp = pa.Codec("snappy").compress(data, asbytes=True)
    assert len(comp) < len(data) // 4   # copies, overlapping their own output
    assert parquet.snappy_decompress(comp) == data


def test_port_files_read_back_by_pyarrow_and_pandas(tmp_path):
    import pandas as pd

    rng = np.random.default_rng(1)
    cols = {"seq": ["".join(rng.choice(list("ACGT"), 30)) for _ in range(50)],
            "name": [None if i % 6 == 0 else f"r{i}" for i in range(50)],
            "i64": np.arange(50, dtype=np.int64) * 10**10,
            "i32": np.arange(50, dtype=np.int32) - 25,
            "f64": rng.standard_normal(50),
            "f32": rng.standard_normal(50).astype(np.float32),
            "ints": [int(v) for v in rng.integers(0, 9, 50)]}
    for compression in ("gzip", None):
        path = tmp_path / f"port_{compression}.parquet"
        parquet.write_parquet(path, cols, compression=compression)
        table = pq.read_table(path).to_pydict()
        assert table["seq"] == cols["seq"] and table["name"] == cols["name"]
        for k in ("i64", "i32", "f64", "f32", "ints"):
            np.testing.assert_array_equal(np.asarray(table[k]), np.asarray(cols[k]), k)
        df = pd.read_parquet(path)
        assert df["seq"].tolist() == cols["seq"]
        np.testing.assert_array_equal(df["f32"].to_numpy(), cols["f32"])
        got = parquet.read_parquet(path)
        assert got["seq"] == cols["seq"] and got["name"] == cols["name"]
        np.testing.assert_array_equal(got["i64"], cols["i64"])
    assert pq.ParquetFile(tmp_path / "port_gzip.parquet").metadata.row_group(0) \
        .column(0).compression == "GZIP"
    with pytest.raises(ValueError, match="equal lengths|unequal"):
        parquet.write_parquet(tmp_path / "bad.parquet", {"a": [1, 2], "b": [1]})


def test_zstd_and_nested_are_refused_by_name(tmp_path):
    """What the reader still refuses of zstd and of nested columns, by name:
    a zstd frame that needs a dictionary, structs, maps and lists of lists
    (JAX's zstd shards and one-level list columns are read since the port
    carries a zstd decoder: ``tests/test_torch_formats.py``); LZ4 pages."""
    # zstandard.compress(b"") with a one-byte dictionary ID (7) in its header
    framed = bytes.fromhex("28b52ffd" "21" "07" "00" "010000")
    with pytest.raises(ValueError, match="x.parquet: column 'a'.*dictionary 7"):
        parquet._decompress(framed, parquet.ZSTD, "x.parquet: column 'a'", 0)
    pq.write_table(pa.table({
        "input_ids": pa.array([[1, 2], [3]], pa.list_(pa.int32())), "label": [0, 1],
        "s": pa.array([{"a": 1}, {"a": 2}]),
        "m": pa.array([[("k", 1)], []], pa.map_(pa.string(), pa.int64())),
        "ll": pa.array([[[1]], [[2, 3]]])}), tmp_path / "nested.parquet")
    got = parquet.read_parquet(tmp_path / "nested.parquet", ["input_ids", "label"])
    assert [list(v) for v in got["input_ids"]] == [[1, 2], [3]]
    for col, what in (("s", "a struct"), ("m", "a map"), ("ll", "a list of lists")):
        with pytest.raises(ValueError, match=f"'{col}' is {what}"):
            parquet.read_parquet(tmp_path / "nested.parquet", [col])
    with pytest.raises(ValueError, match="'s' is a struct"):
        parquet.read_parquet(tmp_path / "nested.parquet")
    pq.write_table(_table(n=8), tmp_path / "lz4.parquet", compression="lz4")
    with pytest.raises(ValueError, match="LZ4"):
        parquet.read_parquet(tmp_path / "lz4.parquet")


# ---------------------------------------------------------------------------
# train/streaming
# ---------------------------------------------------------------------------

WINDOW, BATCH = 32, 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Three port shards of 100 windows (a few of the wrong length, skipped
    by both packages), a TSV shard and a FASTA shard."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGTacgt"), WINDOW if i % 41 else WINDOW - 3))
            for i in range(300)]
    assert streaming.convert_to_shards(seqs, d / "pq", shard_size=100) == 3
    (d / "mixed").mkdir()
    for p in (d / "pq").iterdir():
        (d / "mixed" / p.name).write_bytes(p.read_bytes())
    with open(d / "mixed" / "z_table.tsv", "w") as fh:
        fh.write("name\tseq\n" + "".join(f"r{i}\t{s}\n" for i, s in enumerate(seqs[:70])))
    with open(d / "mixed" / "genome.fa", "w") as fh:
        for c in range(2):
            fh.write(f">chr{c}\n" + "".join(rng.choice(list("ACGTN"), 700)) + "\n")
    with open(d / "firstcol.tsv", "w") as fh:   # no seq column: the first one
        fh.write("sequence\tx\n" + "".join(f"{s}\t1\n" for s in seqs[:40]))
    return d, seqs


def _pair(root, batch=BATCH, **kw):
    kw = dict(dict(window=WINDOW, seed=5, shuffle_buffer=40), **kw)
    return (streaming.StreamingPretrainDataset(root, DnaTokenizer(), batch, **kw),
            jstreaming.StreamingPretrainDataset(root, JaxTokenizer(), batch, **kw))


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("root", ["pq", "mixed"])
def test_stream_byte_equal_to_jax(shards, root):
    """From step 0 across two epoch boundaries, and resumed at step 13."""
    d, _ = shards
    port, jax_ds = _pair(d / root)
    n = 2 * (300 if root == "pq" else 420) // BATCH + 3
    got, want = _take(port.iter_from(0), n), _take(jax_ds.iter_from(0), n)
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    for g, w in zip(_take(port.iter_from(13), 6), want[13:19]):
        _assert_batches_equal(g, w)


def test_eval_split_and_host_shards_equal_jax(shards):
    d, _ = shards
    port, jax_ds = _pair(d / "mixed", eval_shards=2, split="eval", soft_masked_weight=0.0)
    assert [p.name for p in port.shards] == [p.name for p in jax_ds.shards]
    got, want = list(port.eval_batches()), list(jax_ds.eval_batches())
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert len(list(port.eval_batches(2))) == 2
    for rank in (0, 1):
        port, jax_ds = _pair(d / "pq", process_index=rank, process_count=2)
        for epoch in range(3):
            assert port._host_shards(epoch) == jax_ds._host_shards(epoch)
        for g, w in zip(_take(port.iter_from(0), 20), _take(jax_ds.iter_from(0), 20)):
            _assert_batches_equal(g, w)
    with pytest.raises(ValueError, match="no training shards"):
        streaming.StreamingPretrainDataset(d / "pq", DnaTokenizer(), 2, eval_shards=3)


@pytest.mark.parametrize("shard", ["firstcol.tsv", "mixed/genome.fa"])
def test_single_file_shards_equal_jax(shards, shard):
    d, _ = shards
    port, jax_ds = _pair(d / shard, batch=4, stride=25)
    for g, w in zip(_take(port.iter_from(0), 30), _take(jax_ds.iter_from(0), 30)):
        _assert_batches_equal(g, w)


def test_concat_chunks_and_parquet_source_equal_jax(shards):
    from plantcaduceus_tpu.train import data as jdata

    d, seqs = shards
    got = list(streaming.concat_chunks(seqs[:20], 48, DnaTokenizer()))
    want = list(jstreaming.concat_chunks(seqs[:20], 48, JaxTokenizer()))
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    path = d / "pq" / "shard_00001.parquet"
    assert data_lib.sequence_source(str(path)) == jdata.sequence_source(str(path)) \
        == seqs[100:200]


# ---------------------------------------------------------------------------
# cli/pretrain over shards
# ---------------------------------------------------------------------------

CLI = ["--window", str(WINDOW), "--batch-size", "4", "--dtype", "float32", "--log-steps", "1",
       "--eval-shards", "1", "--eval-steps", "7", "--save-steps", "7", "--warmup-steps", "2",
       "--lr", "1e-2", "--device", "cpu"]


def test_pretrain_cli_streams_profiles_and_resumes(shards, tmp_path):
    """``shards:`` with ``--eval-shards 1`` and ``--profile-dir``: the trace
    of steps 10-12 is written; a run stopped at its step-7 checkpoint and
    resumed to step 14 exports the uninterrupted run's bits; a parquet
    dataset loads."""
    from plantcaduceus_tpu_torch.cli import pretrain

    d, seqs = shards
    (tmp_path / "cfg.json").write_text(json.dumps(dict(d_model=16, n_layer=2, vocab_size=16,
                                                       d_state=4)))
    base = CLI + ["--config", str(tmp_path / "cfg.json"), "--dataset", f"shards:{d / 'pq'}"]
    prof = tmp_path / "prof"
    pretrain.main(base + ["--max-steps", "14", "--output-dir", str(tmp_path / "full"),
                          "--profile-dir", str(prof)])
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(str(e.get("name", "")).startswith("aten::") for e in events)
    pretrain.main(base + ["--max-steps", "7", "--output-dir", str(tmp_path / "resumed")])
    pretrain.main(base + ["--max-steps", "14", "--output-dir", str(tmp_path / "resumed")])
    want, got = (torch.load(tmp_path / r / "final" / "pytorch_model.bin", weights_only=True)
                 for r in ("full", "resumed"))
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    parquet.write_parquet(tmp_path / "w.parquet", {"seq": [s for s in seqs if len(s) == WINDOW]})
    pretrain.main(CLI + ["--config", str(tmp_path / "cfg.json"), "--max-steps", "2",
                         "--dataset", str(tmp_path / "w.parquet"),
                         "--output-dir", str(tmp_path / "pq_run")])
    assert (tmp_path / "pq_run" / "final" / "pytorch_model.bin").is_file()


def test_trace_writes_a_chrome_trace_of_its_block(tmp_path):
    from plantcaduceus_tpu_torch.utils import profiling

    with profiling.trace(tmp_path / "prof"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def test_device_memory_stats_per_card():
    from plantcaduceus_tpu_torch.utils import profiling

    stats = profiling.device_memory_stats()
    if torch.cuda.is_available():
        assert sorted(stats) == [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        assert stats == {}
