"""The packed-shard data feed (ROADMAP.md A11) against the JAX package.

Records written by the JAX writer read back equal through the port's reader
and the reverse; the port's PNG codec decodes what ``cv2.imencode`` writes
pixel for pixel, over every PNG filter type; ``ShardedPackedRecordSource``
indexes shards as the JAX source does; and the CLI trains over packed shards
and resumes bit-equal. Every file is written under ``tmp_path``.
"""
import json
import pickle
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from test_torch_unet import one_torch_thread  # noqa: F401 (autouse)

from flaxdiff_tpu.data import packed_records as jax_records
from flaxdiff_tpu.data.sharded_source import ShardedPackedRecordSource as JaxSharded
from flaxdiff_tpu_torch import native, train
from flaxdiff_tpu_torch.data import (PackedRecordReader, PackedRecordSource, PackedRecordWriter,
                                     PythonPackedReader, ShardedPackedRecordSource,
                                     LocalFileSystem, decode_png, decode_standard_record,
                                     encode_png, get_dataset, iterate_batches, pack_record,
                                     unpack_record, write_image_dataset)
from flaxdiff_tpu_torch.data.dataset_map import UNPORTED_DATASETS


def _images(n, side=12, seed=0):
    """Noise, gradients and smooth patches: rows that cv2's adaptive filter
    choice sends to every filter type."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side]
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            img = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)
        elif kind == 1:
            img = np.stack([xx * 9 + i, xx * 4, yy * 3], -1).astype(np.uint8)
        elif kind == 2:
            img = np.stack([yy * 11, (xx + yy) * 5, xx * yy % 256], -1).astype(np.uint8)
        else:
            img = cv2.GaussianBlur(rng.integers(0, 256, (side, side, 3), dtype=np.uint8),
                                   (5, 5), 2)
        out.append(img)
    return out


def _png_filters(png: bytes) -> set:
    """The filter type of every row of a PNG."""
    pos, idat, header = 8, [], None
    while pos < len(png):
        n, kind = struct.unpack_from(">I4s", png, pos)
        body = png[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, _, color = header[:4]
    stride = w * {0: 1, 2: 3, 4: 2, 6: 4}[color] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[r * stride] for r in range(h)}


def _cv2_rgb(png: bytes) -> np.ndarray:
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(png, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


# --- the record format ---------------------------------------------------------------

def test_records_cross_between_the_jax_and_port_writers_and_readers(tmp_path):
    rng = np.random.default_rng(1)
    records = [{"payload": bytes(rng.integers(0, 256, n, dtype=np.uint8)), "k": b"v" * i}
               for i, n in enumerate((10, 0, 1024, 7))]
    assert unpack_record(jax_records.pack_record(records[2])) == records[2]
    assert jax_records.unpack_record(pack_record(records[2])) == records[2]
    for name, writer, reader in (("jax_to_port", jax_records.PackedRecordWriter,
                                  PackedRecordReader),
                                 ("port_to_jax", PackedRecordWriter,
                                  jax_records.PackedRecordReader)):
        path = str(tmp_path / f"{name}.rec")
        with writer(path) as w:
            for r in records:
                w.write(r)
        r = reader(path)
        assert len(r) == 4 and r.version == 2 and r.verify_all() == 0
        assert [r[i] for i in range(4)] == records
        assert r.read_batch([3, 0, 2]) == [pack_record(records[i]) for i in (3, 0, 2)]
        assert all(r.verify(i) for i in range(4))
        with pytest.raises(IndexError):
            r.record_bytes(4)
        r.close()
    # the two writers write the same bytes
    assert ((tmp_path / "jax_to_port.rec").read_bytes()
            == (tmp_path / "port_to_jax.rec").read_bytes())


def test_reader_finds_a_flipped_payload_byte_and_rejects_garbage(tmp_path):
    path = tmp_path / "crc.rec"
    with PackedRecordWriter(str(path)) as w:
        for n in (64, 3, 512):
            w.write(bytes(i % 251 for i in range(n)))
    data = bytearray(path.read_bytes())
    data[-5] ^= 0xFF                       # inside the last record
    path.write_bytes(bytes(data))
    r = PackedRecordReader(str(path))
    assert [r.verify(i) for i in range(3)] == [True, True, False] and r.verify_all() == 1
    assert [PythonPackedReader(LocalFileSystem(), str(path)).verify(i) for i in range(3)] == [
        True, True, False]
    bad = tmp_path / "bad.rec"
    bad.write_bytes(b"NOTAMAGICVALUE" + b"\x00" * 64)
    with pytest.raises(IOError):
        PackedRecordReader(str(bad))


# --- the PNG codec ----------------------------------------------------------------------

def test_decode_png_equals_cv2_on_every_filter_type():
    """The JAX writer's own PNGs (cv2's default filter), and cv2's adaptive
    choice over all five filters, in RGB, gray and RGBA."""
    seen = set()
    for img in _images(8):
        for params in ([], [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS]):
            for arr in (cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                        cv2.cvtColor(img, cv2.COLOR_RGB2GRAY),
                        np.concatenate([img, img[..., :1]], -1)):
                ok, enc = cv2.imencode(".png", arr, params)
                assert ok
                png = enc.tobytes()
                seen |= _png_filters(png)
                np.testing.assert_array_equal(decode_png(png), _cv2_rgb(png))
    assert seen == {0, 1, 2, 3, 4}


def test_encode_png_round_trips_and_cv2_reads_it():
    for img in _images(4, side=9):
        png = encode_png(img)
        np.testing.assert_array_equal(decode_png(png), img)
        np.testing.assert_array_equal(_cv2_rgb(png), img)


def test_jpeg_raises_naming_the_roadmap():
    ok, enc = cv2.imencode(".jpg", _images(1)[0])
    with pytest.raises(ValueError, match="A11's rest"):
        decode_png(enc.tobytes())


def test_image_datasets_cross_between_the_packages(tmp_path):
    images, captions = _images(6), [f"caption {i}" for i in range(6)]
    write_image_dataset(str(tmp_path / "port.rec"), images, captions)
    jax_records.write_image_dataset(str(tmp_path / "jax.rec"), images, captions)
    jax_src = jax_records.PackedRecordSource(str(tmp_path / "port.rec")).get_source()
    port_src = PackedRecordSource(str(tmp_path / "jax.rec")).get_source()
    for i, img in enumerate(images):
        for rec in (jax_src[i], port_src[i]):
            np.testing.assert_array_equal(rec["image"], img)
            assert rec["text"] == captions[i]


def test_decode_standard_record_takes_both_key_namings():
    img = _images(1)[0]
    png = encode_png(img)
    for entries in ({"image": png, "caption": b"a cat"}, {"jpg": png, "txt": b"a cat"}):
        rec = decode_standard_record(entries)
        np.testing.assert_array_equal(rec["image"], img)
        assert rec["text"] == "a cat"
    assert decode_standard_record({"caption": b"only"}) == {"text": "only"}


# --- shards -------------------------------------------------------------------------------

def _shards(tmp_path, counts=(5, 1, 7)):
    images, paths = _images(sum(counts)), []
    start = 0
    for s, n in enumerate(counts):
        paths.append(str(tmp_path / f"shard-{s}.rec"))
        write_image_dataset(paths[-1], images[start:start + n],
                            [f"img {start + i}" for i in range(n)])
        start += n
    return paths, images


def test_sharded_source_indexes_as_the_jax_source(tmp_path):
    paths, images = _shards(tmp_path)
    pattern = str(tmp_path / "shard-*.rec")
    jax_src = JaxSharded(pattern=pattern)
    for src in (ShardedPackedRecordSource(pattern=pattern, max_open=2),
                ShardedPackedRecordSource(shards=paths, filesystem=LocalFileSystem())):
        assert len(src.get_source()) == len(jax_src.get_source()) == len(images)
        assert [src.locate(i) for i in range(len(images))] == [
            jax_src.locate(i) for i in range(len(images))]
        with pytest.raises(IndexError):
            src.locate(len(images))
        view = src.get_source()
        for i in (0, 5, 12, 3):
            np.testing.assert_array_equal(view[i]["image"], images[i])
            assert view[i]["text"] == f"img {i}"
        assert len(src._readers) <= src.max_open
        clone = pickle.loads(pickle.dumps(src))
        assert not clone._readers and clone.locate(7) == src.locate(7)
        np.testing.assert_array_equal(clone.get_source()[7]["image"], images[7])
    raw = ShardedPackedRecordSource(pattern=pattern, decode=False).get_source()[0]
    assert set(raw) == {"image", "caption"}


def test_registry_builds_the_packed_datasets_and_names_what_it_lacks(tmp_path):
    _shards(tmp_path)
    ds = get_dataset("packed_shards", root=str(tmp_path / "*.rec"), image_size=8)
    batch = next(iterate_batches(ds, 4, seed=1))
    assert batch["sample"].shape == (4, 8, 8, 3) and len(batch["text"]) == 4
    for part in ("a", "b"):
        (tmp_path / "mix" / part).mkdir(parents=True)
        _shards(tmp_path / "mix" / part, counts=(2,))
        for p in (tmp_path / "mix" / part).glob("*.rec"):
            p.rename(p.with_suffix(".pack"))
    mix = get_dataset("combined_aesthetic", root=str(tmp_path / "mix"), parts=["a", "b"])
    assert len(mix.get_source()) == 4
    with pytest.raises(FileNotFoundError, match="'c'"):
        get_dataset("combined_aesthetic", root=str(tmp_path / "mix"), parts=["a", "c"])
    for name in sorted(UNPORTED_DATASETS):
        with pytest.raises(SystemExit):
            train.parse_args(["--dataset", name])
    with pytest.raises(SystemExit):
        train.parse_args(["--dataset", "online:laion"])


def test_native_library_builds_from_the_port_sources():
    root = native.HERE
    assert all(src.resolve().is_relative_to(root) for src in native.SOURCES)
    lib = native.library()
    assert lib.png_unfilter is not None and lib.pr_open is not None


# --- the CLI over packed shards -----------------------------------------------------

def _cli(ckpt_dir, shards, total):
    model = dict(emb_features=16, feature_depths=[8, 16], attention_configs=[None, None],
                 num_res_blocks=1, norm_groups=4)
    return ["--dataset", "packed_shards", "--dataset_path", shards, "--text_encoder", "hash",
            "--image_size", "8", "--batch_size", "4", "--model_config", json.dumps(model),
            "--dtype", "float32", "--optimizer", "adamw", "--lr", "1e-3", "--warmup_steps", "2",
            "--total_steps", str(total), "--save_every", "2", "--log_every", "2",
            "--checkpoint_dir", str(ckpt_dir), "--device", "cpu", "--seed", "1"]


def test_cli_fit_over_packed_shards_resumes_bit_equal(tmp_path):
    """Four steps over three shards (13 records: three batches an epoch, so
    the stream crosses an epoch), stopped after two and resumed, equal bit
    for bit to four uninterrupted steps."""
    (tmp_path / "data").mkdir()
    _shards(tmp_path / "data")
    shards = str(tmp_path / "data" / "shard-*.rec")
    run = train.make_run(_cli(tmp_path / "a", shards, 4))
    hist = run.trainer.fit(run.batches(0), total_steps=2, save_every=2)
    run.trainer.checkpointer.close()
    assert all(np.isfinite(hist["loss"]))
    train.main(_cli(tmp_path / "a", shards, 4))
    hist = train.main(_cli(tmp_path / "b", shards, 4))
    assert all(np.isfinite(hist["loss"]))
    resumed = train.make_run(_cli(tmp_path / "a", shards, 4)).trainer
    whole = train.make_run(_cli(tmp_path / "b", shards, 4)).trainer
    assert resumed.state.step == whole.state.step == 4
    for name, buf in whole.state.buffers().items():
        assert torch.equal(resumed.state.buffers()[name], buf), name
