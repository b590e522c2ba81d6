"""CLIP open-vocabulary prompt templates.

Counterpart of `iggt_official_tpu/utils/prompt_engineering.py`, copied.
Role of `utils/prompt_engineering.py:4-98` in the reference (open-vocab
leftovers — nothing in the demo/eval path consumes them, see SURVEY §2.6).
Templates are the standard OpenAI CLIP ImageNet prompt-ensembling set.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Union

import numpy as np

PROMPT_TEMPLATES: List[str] = [
    "{}.",
    "a photo of a {}.",
    "a photo of the {}.",
    "a photo of one {}.",
    "a photo of many {}.",
    "a bad photo of a {}.",
    "a bad photo of the {}.",
    "a good photo of a {}.",
    "a good photo of the {}.",
    "a cropped photo of a {}.",
    "a cropped photo of the {}.",
    "a close-up photo of a {}.",
    "a close-up photo of the {}.",
    "a bright photo of a {}.",
    "a bright photo of the {}.",
    "a dark photo of a {}.",
    "a dark photo of the {}.",
    "a low resolution photo of a {}.",
    "a low resolution photo of the {}.",
    "a blurry photo of a {}.",
    "a blurry photo of the {}.",
    "a pixelated photo of a {}.",
    "a pixelated photo of the {}.",
    "a jpeg corrupted photo of a {}.",
    "a jpeg corrupted photo of the {}.",
    "a black and white photo of a {}.",
    "a black and white photo of the {}.",
    "a photo of a clean {}.",
    "a photo of the clean {}.",
    "a photo of a dirty {}.",
    "a photo of the dirty {}.",
    "a photo of a small {}.",
    "a photo of the small {}.",
    "a photo of a large {}.",
    "a photo of the large {}.",
    "a photo of a cool {}.",
    "a photo of the cool {}.",
    "a photo of a nice {}.",
    "a photo of the nice {}.",
    "a photo of a weird {}.",
    "a photo of the weird {}.",
    "a photo of a hard to see {}.",
    "a photo of the hard to see {}.",
    "a photo of my {}.",
    "a rendering of a {}.",
    "a rendering of the {}.",
    "a rendition of a {}.",
    "a rendition of the {}.",
    "a sculpture of a {}.",
    "a sculpture of the {}.",
    "a painting of a {}.",
    "a painting of the {}.",
    "a drawing of a {}.",
    "a drawing of the {}.",
    "a sketch of a {}.",
    "a sketch of the {}.",
    "a doodle of a {}.",
    "a doodle of the {}.",
    "a cartoon {}.",
    "the cartoon {}.",
    "a tattoo of a {}.",
    "a tattoo of the {}.",
    "the embroidered {}.",
    "a embroidered {}.",
    "a plastic {}.",
    "the plastic {}.",
    "a toy {}.",
    "the toy {}.",
    "the origami {}.",
    "a origami {}.",
    "graffiti of a {}.",
    "graffiti of the {}.",
    "a photo of a {} in a video game.",
    "a photo of the {} in a video game.",
]

SIMPLE_TEMPLATES: List[str] = [
    "{}.",
    "a photo of a {}.",
    "a photo of the {}.",
    "there is a {} in the scene.",
    "this is a photo of a {}.",
]


def get_prompt_templates() -> List[str]:
    return list(PROMPT_TEMPLATES)


def prompt_engineering(
    classnames: Union[str, Sequence[str]], topk: int = 1, suffix: str = "."
) -> str:
    """Pick a random template among the first ``topk`` and fill it with the
    class name (a random synonym if a list is given)."""
    templates = get_prompt_templates()
    idx = int(np.random.randint(min(len(templates), topk)))
    name = (
        random.choice(list(classnames))
        if isinstance(classnames, (list, tuple))
        else classnames
    )
    name = name.replace(",", "").replace("+", " ")
    return templates[idx].replace(".", suffix).format(name)
