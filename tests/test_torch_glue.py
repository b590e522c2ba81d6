"""The port's open-vocabulary utilities (`iggt_official_tpu_torch/utils/
{visualizer,prompt_engineering,constants}.py`) against the JAX package's:
the scenarios of `tests/test_glue_utils.py` (visualizer, colours, prompts,
vocabularies), drawings equal byte for byte and prompts equal under the same
seeds.
"""

import random

import numpy as np
import pytest

from iggt_official_tpu.utils import constants as jconst
from iggt_official_tpu.utils import prompt_engineering as jprompt
from iggt_official_tpu.utils import visualizer as jvis
from iggt_official_tpu_torch.utils import constants as tconst
from iggt_official_tpu_torch.utils import prompt_engineering as tprompt
from iggt_official_tpu_torch.utils import visualizer as tvis


def drawings(mod, img, masks):
    out = [mod.Visualizer(img).draw_instances(masks, labels=["chair", "table", "lamp"],
                                              scores=[0.9, 0.8, 0.55]),
           mod.Visualizer(img, alpha=0.3).draw_instances(masks, scores=[0.9, 0.8, 0.5],
                                                         boxes=np.array([[5, 5, 30, 20],
                                                                         [30, 25, 59, 44],
                                                                         [0, 0, 70, 50.4]])),
           mod.Visualizer(img).draw_instances(masks),
           mod.Visualizer(img).draw_sem_seg(np.where(masks[0], 3, np.where(masks[1], 1, 255)),
                                            class_names=["a", "b", "c", "wall"]),
           mod.Visualizer(img).draw_sem_seg(np.where(masks[1], 9, 0)),
           mod.Visualizer(img).draw_panoptic_seg(np.where(masks[1], 7, 0),
                                                 [{"id": 7, "category_name": "sofa"}, {"id": 0}]),
           mod.Visualizer(img).draw_binary_mask(masks[2], label="x", alpha=0.9),
           mod.Visualizer(img).draw_box((5, 5, 30, 20), color=(255, 0, 0))]
    v = mod.Visualizer(img[..., 0])
    v.draw_binary_mask(masks[0], color=(10, 20, 30))
    out.append(v.get_image())
    return out


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_visualizer_draws_instances_and_labels(kind):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    if kind == "float":
        img = img.astype(np.float32) / 255 * 1.1 - 0.05      # clipped to [0, 1]
    masks = np.zeros((3, 48, 64), bool)
    masks[0, 5:20, 5:30] = True
    masks[1, 25:45, 30:60] = True
    masks[2] = rng.uniform(0, 1, (48, 64)) < 0.1
    for want, got in zip(drawings(jvis, img, masks), drawings(tvis, img, masks)):
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    out = drawings(tvis, img, masks)[0]
    assert (out[0, 0] == tvis.Visualizer(img).img[0, 0]).all()
    assert (out[10, 10] != tvis.Visualizer(img).img[10, 10]).any()


def test_instance_colors_distinct():
    for i in list(range(40)) + [1023, 4096]:
        for kw in ({}, {"s": 0.4, "v": 0.7}):
            got, want = tvis.instance_color(i, **kw), jvis.instance_color(i, **kw)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert len({tuple(tvis.instance_color(i)) for i in range(30)}) >= 28
    m = np.zeros((7, 9), bool)
    m[1:6, 2:8] = True
    np.testing.assert_array_equal(tvis._contour(m), jvis._contour(m))


def test_prompt_templates():
    assert tprompt.get_prompt_templates() == jprompt.get_prompt_templates()
    assert tprompt.SIMPLE_TEMPLATES == jprompt.SIMPLE_TEMPLATES
    assert len(tprompt.get_prompt_templates()) >= 60
    for args in ((("sofa",), {"topk": 1}), ((["arm chair", "seat+back"],), {"topk": 1, "suffix": ":"}),
                 ((("a,b", "c"),), {"topk": 80}), (("lamp",), {"topk": 20, "suffix": "!"})):
        outs = []
        for mod in (jprompt, tprompt):
            np.random.seed(3)
            random.seed(3)
            outs.append([mod.prompt_engineering(*args[0], **args[1]) for _ in range(8)])
        assert outs[0] == outs[1]
    np.random.seed(0)
    assert tprompt.prompt_engineering("sofa", topk=1) == "sofa."


def test_class_vocabularies():
    names = [n for n in dir(jconst) if n.endswith("_CLASSES")]
    assert sorted(names) == sorted(n for n in dir(tconst) if n.endswith("_CLASSES"))
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    assert len(tconst.COCO_THING_CLASSES) == 80 and len(tconst.COCO_PANOPTIC_CLASSES) == 133
    assert len(tconst.ADE150_CLASSES) == 150 and len(tconst.PASCAL_VOC_CLASSES) == 21
    assert len(tconst.CITYSCAPES_CLASSES) == 19 and len(tconst.SCANNET20_CLASSES) == 20
