"""The port's 2-D mask sets (`iggt_official_tpu_torch/data/seg2d.py`,
`iggt_official_tpu_torch/data/tsv.py`) against the JAX package's on the same
files: the scenarios of `tests/test_data.py` (EntityImage, SAV masklets, TSV
round trip, split labels, SA-1B).  Masks are held equal, and samples equal
array for array under the same seed.
"""

import base64
import io
import json
import os

import numpy as np
import PIL.Image
import pytest

from iggt_official_tpu.data import rle as jrle
from iggt_official_tpu.data import seg2d as jseg
from iggt_official_tpu.data import tsv as jtsv
from iggt_official_tpu_torch.data import rle as trle
from iggt_official_tpu_torch.data import seg2d as tseg
from iggt_official_tpu_torch.data import tsv as ttsv


def assert_samples_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        a, b = want[k], got[k]
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k
        else:
            assert a == b, k


def test_decode_segmentation():
    rng = np.random.default_rng(0)
    H, W = 37, 53
    m = rng.uniform(0, 1, (H, W)) < 0.3
    for seg in (jrle.encode(m), jrle.encode(m, compress=False),
                [[5.0, 4.0, 40.5, 6.0, 30.0, 30.0, 4.0, 20.0], [45.0, 30.0, 50.0, 33.0, 47.0, 36.0]],
                [[1.0, 1.0, 9.0, 9.0]]):             # a degenerate 2-point polygon draws nothing
        got, want = tseg.decode_segmentation(seg, H, W), jseg.decode_segmentation(seg, H, W)
        assert got.dtype == want.dtype == bool and np.array_equal(got, want)
    np.testing.assert_array_equal(tseg.decode_segmentation(trle.encode(m), H, W), m)


def write_entity_set(root, rng, H=64, W=80):
    os.makedirs(root / "imgs")
    coco = {"images": [], "annotations": []}
    for i, (h, w) in enumerate(((H, W), (W, H), (30, 40))):
        PIL.Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            root / "imgs" / f"{i}.jpg")
        coco["images"].append({"id": 10 + i, "file_name": f"{i}.jpg", "height": h, "width": w})
        m = np.zeros((h, w), np.uint8)
        m[3:h // 2, 5:w // 2] = 1
        coco["annotations"] += [
            {"id": 2 * i, "image_id": 10 + i, "segmentation": jrle.encode(m > 0)},
            {"id": 2 * i + 1, "image_id": 10 + i,
             "segmentation": [[w * 0.6, h * 0.6, w - 2.0, h * 0.6, w - 2.0, h - 2.0]]}]
    with open(root / "ann.json", "w") as f:
        json.dump(coco, f)


def test_entity_image_dataset(tmp_path):
    write_entity_set(tmp_path, np.random.default_rng(4))
    args = (str(tmp_path / "imgs"), str(tmp_path / "ann.json"))
    for res in (48, 24):
        ds_j, ds_t = jseg.EntityImage(*args, resolution=res, seed=0), \
            tseg.EntityImage(*args, resolution=res, seed=0)
        assert len(ds_t) == len(ds_j) == 3 and ds_t.ids == ds_j.ids
        for idx in (0, 1, 2, 4, 0, 2):     # repeated draws walk both seeded RNGs alike
            want, got = ds_j[idx], ds_t[idx]
            assert_samples_equal(want, got)
            assert got["img"].shape == (res, res, 3) and got["instance_ids"].shape == (res, res)


def test_sav_dataset(tmp_path):
    H, W = 32, 40
    masklet = []
    for f in range(4):
        frame_masks = []
        for k in range(5 if f != 2 else 0):
            m = np.zeros((H, W), np.uint8)
            m[k * 6: k * 6 + 6, f: f + 20] = 1
            frame_masks.append(jrle.encode(m > 0))
        masklet.append(frame_masks)
    p = tmp_path / "auto_masks.json"
    with open(p, "w") as f:
        json.dump({"masklet": masklet}, f)
    for frames, n, seed in (([0, 2, 3, 9], 2, 0), (1, None, None), ([3, 1], 7, 5), ([0, 1], 3, 11)):
        want = jseg.SAVDataset().sample_masks_from_frames(str(p), frames, n, seed)
        got = tseg.SAVDataset().sample_masks_from_frames(str(p), frames, n, seed)
        assert want.keys() == got.keys()
        for k in want:
            assert len(want[k]) == len(got[k])
            for a, b in zip(want[k], got[k]):
                assert a.dtype == b.dtype == bool and np.array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tseg.SAVDataset().load_annotation_from_json(str(tmp_path / "missing.json"))


def write_sa1b_shard(path, n_rows, H=48, W=64, seed=0, n_masks=3):
    """tests/test_data.py's shard, with seeded rectangles, a crowd and (row 1)
    an empty annotation list."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n_rows):
            buf = io.BytesIO()
            PIL.Image.fromarray(rng.integers(0, 255, (H, W, 3), dtype=np.uint8)).save(
                buf, format="JPEG" if i % 2 else "PNG")
            b64 = base64.b64encode(buf.getvalue()).decode("ascii")
            annos = []
            for k in range(0 if i == 1 else n_masks):
                m = np.zeros((H, W), np.uint8)
                y0, x0 = rng.integers(0, H - 8), rng.integers(0, W - 8)
                m[y0:y0 + rng.integers(3, 20), x0:x0 + rng.integers(3, 30)] = 1
                ys, xs = np.nonzero(m)
                annos.append({"segmentation": jrle.encode(m > 0),
                              "bbox": [int(xs.min()), int(ys.min()), 1, 1],
                              "point_coords": [[float(xs.mean()), float(ys.mean())]],
                              "iscrowd": int(k == n_masks - 1 and i == 2)})
            record = {"image": {"height": H, "width": W}, "annotations": annos}
            f.write(f"img_{i}\t{json.dumps(record)}\t{b64}\n")


def test_tsv_file_roundtrip(tmp_path):
    write_sa1b_shard(tmp_path / "sa1b_0.tsv", 5)
    tsv_t = ttsv.TSVFile(str(tmp_path / "sa1b_0.tsv"))       # writes the .lineidx
    lineidx = (tmp_path / "sa1b_0.lineidx").read_bytes()
    os.remove(tmp_path / "sa1b_0.lineidx")
    tsv_j = jtsv.TSVFile(str(tmp_path / "sa1b_0.tsv"))
    assert (tmp_path / "sa1b_0.lineidx").read_bytes() == lineidx
    assert tsv_t.num_rows() == len(tsv_j) == 5
    for i in (3, 0, 4, 1, 1, 2):
        row = tsv_t.seek(i)
        assert row == tsv_j.seek(i) and row[0] == f"img_{i}" and len(row) == 3
        a, b = ttsv.img_from_base64(row[-1]), jtsv.img_from_base64(row[-1])
        assert a.size == (64, 48) and np.array_equal(np.asarray(a), np.asarray(b))
    tsv_t._pid = -1                        # as in a forked worker: the file reopens
    assert tsv_t.seek(2)[0] == "img_2"
    tsv_t.close()
    assert ttsv.TSVFile(str(tmp_path / "sa1b_0.tsv")).seek(4)[0] == "img_4"
    with pytest.raises(FileExistsError):
        ttsv.generate_lineidx(str(tmp_path / "sa1b_0.tsv"), str(tmp_path / "sa1b_0.lineidx"))


def test_tsv_split_label(tmp_path):
    shard = tmp_path / "d_0.tsv"
    with open(shard, "w") as f:
        for i in range(3):
            f.write(f"k{i}\tpayload{i}\n")
    with open(tmp_path / "d_0.label", "w") as f:
        for i in range(3):
            f.write(f"k{i}\tmid\tlabel{i}\n")
    ttsv.generate_lineidx(str(tmp_path / "d_0.label"), str(tmp_path / "d_0.label.lineidx"))
    tsv_t, tsv_j = ttsv.TSVFile(str(shard)), jtsv.TSVFile(str(shard))
    for i in (1, 0, 2):
        assert tsv_t.seek(i) == tsv_j.seek(i) == [f"k{i}", f"label{i}", f"payload{i}"]


def test_sa1b_dataset(tmp_path):
    write_sa1b_shard(tmp_path / "sa1b_0.tsv", 3)
    write_sa1b_shard(tmp_path / "sa1b_1.tsv", 2, seed=1, n_masks=5)
    write_sa1b_shard(tmp_path / "sa1b_7.tsv", 2, seed=2)
    write_sa1b_shard(tmp_path / "extra.tsv", 1, seed=3)
    for rng in ((0, 2), (0, 100), (1, 8), (5, 6)):
        assert ttsv.list_tsv_shards(str(tmp_path), *rng) == jtsv.list_tsv_shards(str(tmp_path), *rng)
    assert len(ttsv.list_tsv_shards(str(tmp_path))) == 4
    for kw in ({"image_size": 64, "subset": (0, 2)}, {"image_size": 40, "subset": (0, 8)},
               {"image_size": 96, "min_scale": 0.5, "max_scale": 3.0},
               {"image_size": 64, "is_train": False, "subset": (0, 8)},
               {"image_size": 64, "random_flip": "none"}):
        ds_j, ds_t = jtsv.SA1BDataset(str(tmp_path), seed=3, **kw), \
            ttsv.SA1BDataset(str(tmp_path), seed=3, **kw)
        assert len(ds_t) == len(ds_j) and ds_t.index == ds_j.index
        for idx in list(range(len(ds_t))) + [0, len(ds_t) + 1]:
            want, got = ds_j[idx], ds_t[idx]
            assert_samples_equal(want, got)
            S, n = kw["image_size"], len(got["gt_masks"])
            assert got["image"].shape == got["sam_image"].shape == (S, S, 3)
            assert got["padding_mask"].shape == (S, S) and got["gt_masks"].shape == (n, S, S)
            assert got["gt_boxes"].shape == got["point_coords"].shape == (n, 4)
    masks = np.zeros((3, 8, 9), bool)
    masks[0, 2:5, 3:7] = True
    masks[2, 7, 0] = True
    np.testing.assert_array_equal(ttsv.masks_to_boxes(masks), jtsv.masks_to_boxes(masks))
