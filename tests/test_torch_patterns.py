"""The port's watermark stamps (attack/patterns.py: copyright and apple)
and its TensorBoard sink (utils/metrics.MetricsWriter) against the JAX
package's.

(a) the copyright and apple stamps on fmnist (the uint8 wraparound of
PARITY.md quirk 10) and fedemnist, bit for bit: the procedural mark (JAX
seeds it from hash(name), which is stable only within one process, so
both sides run here), and a PNG written with cv2 under `tmp_path`, reached
through `data_dir` and through `RLR_ASSET_DIR`. (b) the writer makes an
event file when torch.utils.tensorboard imports and none under
--no_tensorboard, with the same metrics.jsonl rows either way.

At most two tests per test_torch_* file (see tests/test_torch_rlr_fused.py).
"""

import json

import cv2
import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)

from defending_against_backdoors_with_robust_learning_rate_tpu.attack import (
    patterns as jax_patterns, poison as jax_poison)
from defending_against_backdoors_with_robust_learning_rate_tpu.config import (
    Config as JaxConfig)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.attack import (
    patterns, poison)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.config import (
    Config)
from defending_against_backdoors_with_robust_learning_rate_tpu_torch.utils.metrics import (
    MetricsWriter)

WATERMARKS = ("copyright", "apple")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _images(rng, data, n=6):
    if data == "fmnist":        # raw uint8 pixels, bright enough for the
        # mark's add to wrap
        return rng.integers(180, 256, size=(n, 28, 28, 1), dtype=np.uint8)
    return rng.normal(size=(n, 28, 28, 1)).astype(np.float32)


def _same_stamps(data_dir, rng, what):
    """Every watermark stamp of fmnist and fedemnist, its application, and
    the poisoned rows and val set it gives, port vs JAX, bit for bit.
    Returns the port's stamps."""
    out = {}
    for data in ("fmnist", "fedemnist"):
        for ptype in WATERMARKS:
            tag = f"{what} {data}/{ptype}"
            w = jax_patterns.build_stamp(data, ptype, data_dir=data_dir)
            g = patterns.build_stamp(data, ptype, data_dir=data_dir)
            assert g.mode == w.mode == (patterns.ADD_WRAP_U8
                                        if data == "fmnist"
                                        else patterns.SUB_FLOAT), tag
            np.testing.assert_array_equal(g.mask, w.mask, err_msg=tag)
            np.testing.assert_array_equal(g.value, w.value, err_msg=tag)
            assert g.mask.all()
            x = _images(rng, data)
            got = patterns.apply_stamp(x, g)
            want = np.asarray(jax_patterns.apply_stamp(x, w))
            assert got.dtype == want.dtype, tag
            np.testing.assert_array_equal(got, want, err_msg=tag)
            if data == "fmnist":
                # the uint8 add wraps mod 256 where the mark is bright
                wrapped = (x.astype(np.int32) + g.value[..., None].astype(
                    np.uint8)) > 255
                assert wrapped.any(), tag
                assert (got[wrapped] < x[wrapped]).all(), tag
            kw = dict(data=data, pattern_type=ptype, num_corrupt=2,
                      poison_frac=0.5, base_class=5, data_dir=data_dir)
            labels = rng.integers(0, 10, size=(3, 12)).astype(np.int32)
            labels[:, :4] = 5
            imgs = np.stack([_images(rng, data, 12) for _ in range(3)])
            sizes = np.array([12, 9, 12])
            for g_out, w_out in zip(
                    poison.poison_agent_shards(imgs, labels, sizes,
                                               Config(**kw)),
                    jax_poison.poison_agent_shards(imgs, labels, sizes,
                                                   JaxConfig(**kw))):
                assert g_out.dtype == w_out.dtype, tag
                np.testing.assert_array_equal(g_out, w_out, err_msg=tag)
            for g_out, w_out in zip(
                    poison.build_poisoned_val(imgs[0], labels[0],
                                              Config(**kw)),
                    jax_poison.build_poisoned_val(imgs[0], labels[0],
                                                  JaxConfig(**kw))):
                np.testing.assert_array_equal(g_out, w_out, err_msg=tag)
            out[data, ptype] = g
    return out


def test_watermark_stamps_match_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    monkeypatch.delenv("RLR_ASSET_DIR", raising=False)
    empty = str(tmp_path / "no_assets" / "data")
    # the same search path, the repository's assets/ directory included
    assert (patterns._asset_search_path(empty)
            == jax_patterns._asset_search_path(empty))
    for name in ("watermark.png", "apple.png"):
        assert patterns._load_watermark(name, empty) is None
        np.testing.assert_array_equal(
            patterns._procedural_watermark(name),
            jax_patterns._procedural_watermark(name))
    procedural = _same_stamps(empty, rng, "procedural")

    # PNG assets, written here with cv2: reached through data_dir, then
    # through RLR_ASSET_DIR
    assets = tmp_path / "assets"
    assets.mkdir()
    for i, name in enumerate(("watermark.png", "apple.png")):
        img = np.zeros((64, 48), np.uint8)
        img[8 + 8 * i:40, 6:42 - 4 * i] = 230
        img[20:28, :] = 17
        cv2.imwrite(str(assets / name), img)
    from_dir = _same_stamps(str(assets), rng, "data_dir")
    monkeypatch.setenv("RLR_ASSET_DIR", str(assets))
    assert patterns._asset_search_path(empty)[0] == str(assets)
    from_env = _same_stamps(empty, rng, "RLR_ASSET_DIR")
    for key, stamp in from_dir.items():
        # the loaded asset, not the fallback: inverted and resized
        np.testing.assert_array_equal(from_env[key].value, stamp.value)
        assert not np.array_equal(stamp.value, procedural[key].value)
    assert from_dir["fmnist", "copyright"].value.max() == 255.0
    assert not np.array_equal(from_dir["fmnist", "copyright"].value,
                              from_dir["fmnist", "apple"].value)


def _rows(run_dir):
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows[0]["tag"] == "_run/start"
    return rows[1:]


def test_metrics_writer_tensorboard_sink(tmp_path):
    scalars = [("Validation/Accuracy", 0.5, 1), ("Defense/Vote_Margin_Hist/3",
                                                 0.125, 1),
               ("Validation/Accuracy", 0.75, 2)]
    for tb in (True, False):
        with MetricsWriter(str(tmp_path / str(tb)), "run",
                           tensorboard=tb) as w:
            for tag, value, step in scalars:
                w.scalar(tag, value, step)
    on, off = tmp_path / "True" / "run", tmp_path / "False" / "run"
    events = sorted(p.name for p in on.iterdir()
                    if p.name.startswith("events.out.tfevents"))
    assert len(events) == 1
    assert (on / events[0]).stat().st_size > 0
    assert sorted(p.name for p in off.iterdir()) == ["metrics.jsonl"]
    assert _rows(on) == _rows(off) == [
        {"tag": t, "value": v, "step": s} for t, v, s in scalars]
    # the event file holds the scalars, read back through tensorboard
    acc = EventAccumulator(str(on))
    acc.Reload()
    assert [(e.step, e.value) for e in acc.Scalars("Validation/Accuracy")] \
        == [(1, 0.5), (2, 0.75)]
