"""The port's config loaders (`iggt_official_tpu_torch/utils/config_io.py`,
`utils/arguments.py`) against the JAX package's on the same files, and the
port's YAML subset reader (`utils/yaml_subset.py`) held to ``yaml.safe_load``
on every text these tests write; texts outside the subset must raise, naming
the line.  The scenarios of `tests/test_utils_misc.py` (`test_config_loader`,
`test_py_config_fromfile_with_base`, `test_parse_configs_cli_override`,
`test_cfgnode_yaml_base_and_merge`).  One test runs the config loaders and
the converters in a subprocess where importing ``yaml`` or ``cv2`` fails.
"""

import math
import os
import subprocess
import sys
import textwrap

import pytest
import yaml

from iggt_official_tpu.utils import arguments as jargs
from iggt_official_tpu.utils import config_io as jcfg
from iggt_official_tpu_torch.utils import arguments as targs
from iggt_official_tpu_torch.utils import config_io as tcfg
from iggt_official_tpu_torch.utils import yaml_subset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IN_SUBSET = [
    "MODEL:\n  DEPTH: 24\n  DIM: 1024\nSOLVER:\n  LR: 0.001\n",
    "_BASE_: base.yaml\nMODEL:\n  DEPTH: 12\n",
    "model.depth: 4\nmodel.dim: 64\nlr: 0.1\n",
    "# a comment\n---\nkey: value   # trailing comment\nlist:\n- 1\n- two\n- 3.5\n-\n"
    "- - nested\n  - more\n- k: v\n  k2: [a, 'b c']\n",
    "a: [1, 2, [3, 4], {b: c, d: [e]}]\nb: {x: 1, y: 'two', z: \"th\\\"ree\"}\nc: []\nd: {}\n",
    "bools: [yes, No, TRUE, off, On, y, n, true, False]\nnulls: [~, null, Null, NULL]\nempty:\n",
    "ints: [0, -12, +7, 0x1F, 0b101, 017, 1_000, 1:30, 08, 012_3]\n",
    "floats: [1.5, -0.5, .5, 1.0e-4, 1e-4, 1.0e4, .inf, -.Inf, +.INF, .NaN, 1:30.5, 3., 6.5e+3]\n",
    "quoted: 'it''s'\ndq: \"tab\\tnl\\nuni\\u00e9 \\x41 \\\\ \\/\"\nplain: it's fine # c\n"
    "url: http://example.com:80/x\ncolon:in: a\nhash: a#b\nqhash: 'a # b'\n",
    "top:\n  - a\n  - b:\n      c: 1\n    d: 2\n  -   e\n",
    "seq_same_indent:\n- 1\n- 2\nnext: 3\nmapped:\n- name: x\n  size: [1, 2]\n- name: y\n",
    "1: one\ntrue: t\nnull: n\n3.5: f\n'quoted key': 1\n\"dq key\": 2\nkey with spaces: v w\n",
    "just a scalar\n",
    "- a\n- b\n",
    "",
    "# only comments\n\n   \n",
    "a:\n    b:\n        c: [ ]\n    d: { }\n",
    "a: b,c\nb: x]\nc: -1\nd: 2001-12-1\ne: 1.2.3\nf: 0o17\ng: 1_0.5\n",
    "a: [1, 2,]\nb: {a: 1,}\nc: {a}\nd: [[1, 2], [3, 4]]\ne: {k: [1, {m: n}]}\n",
    "deep:\n  - - 1\n    - 2\n  - - 3\nindented:\n   - x\n   - y\n",
    "SOLVER:\n  BASE_LR: 2.0e-4\n  STEPS: [30000, 40000]\n  AMP:\n    ENABLED: true\n"
    "INPUT:\n  MIN_SIZE_TRAIN: [640, 672, 704]\n  FORMAT: \"RGB\"\n",
]

OUTSIDE = [
    ("a: &x 1\n", 1, "anchor"), ("a: *x\n", 1, "alias"), ("a: !!str 1\n", 1, "tag"),
    ("a: |\n  x\n", 1, "block scalar"), ("a: >\n  x\n", 1, "block scalar"),
    ("a: 1\n---\nb: 2\n", 2, "document"), ("---\na: 1\n...\n", 3, "document"),
    ("? a\n: b\n", 1, "complex key"), ("<<: {a: 1}\n", 1, "merge"),
    ("a: 2001-12-14\n", 1, "timestamp"), ("%YAML 1.1\n---\na: 1\n", 1, "directive"),
    ("a: b\n  c\n", 2, "continuation"), ("a: [1,\n 2]\n", 1, "multi-line"),
    ("a:\n\tb: 1\n", 2, "tab"), ("a: 'x\n  y'\n", 1, "quoted"), ("a: b: c\n", 1, "mapping"),
    ("- a\nb: 1\n", 2, "unexpected"), ("a: [b: c]\n", 1, "flow sequence"),
    ("a: -\n", 1, "sequence entry"),
]


def same(a, b):
    """Equal values of equal types (nan equal to nan)."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def assert_like_pyyaml(text):
    want, got = yaml.safe_load(text), yaml_subset.load(text)
    assert same(want, got), (text, want, got)


@pytest.mark.parametrize("i", range(len(IN_SUBSET)))
def test_subset_reader_equals_safe_load(i):
    assert_like_pyyaml(IN_SUBSET[i])


@pytest.mark.parametrize("text,line,what", OUTSIDE)
def test_subset_reader_refuses_outside(text, line, what):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"^line {line}: .*{what}"):
        yaml_subset.load(text)


def test_config_loader(tmp_path):
    texts = {"a.yaml": "model.depth: 4\nmodel.dim: 64\nlr: 0.1\nsizes: [1, 2]\n",
             "b.yaml": "model.depth: 8\nname: 'x y'\n", "c.yml": "# empty overrides\n{}\n"}
    for name, text in texts.items():
        (tmp_path / name).write_text(text)
        assert_like_pyyaml(text)
    files = [str(tmp_path / n) for n in texts]
    opt_t, opt_j = targs.load_opt_from_config_files(files), jargs.load_opt_from_config_files(files)
    assert opt_t == opt_j == {"model": {"depth": 8, "dim": 64}, "lr": 0.1, "sizes": [1, 2],
                              "name": "x y"}
    for opt in (opt_t, opt_j):
        (targs if opt is opt_t else jargs).load_config_dict_to_opt(opt, {"model.dim": 128,
                                                                         "new.a.b": 1})
    assert opt_t == opt_j and opt_t["model"]["dim"] == 128 and opt_t["new"] == {"a": {"b": 1}}
    assert targs.load_opt_from_config_file(files[0]) == jargs.load_opt_from_config_file(files[0])
    with pytest.raises(TypeError):
        targs.load_config_dict_to_opt({}, ["not", "a", "dict"])
    argv = ["train", "--conf_files", files[0], files[1], "--overrides", "model.depth", "16",
            "lr", "[1e-3, 2]", "name", "plain words"]
    assert targs.load_opt_command(argv) == jargs.load_opt_command(argv)
    (tmp_path / "c.json").write_text('{"model.depth": 3, "lr": 1e-5, "flag": true}')
    json_files = [str(tmp_path / "c.json")]
    assert same(targs.load_opt_from_config_files(json_files),
                jargs.load_opt_from_config_files(json_files))


BS = chr(92)   # a backslash, for the JSON texts' escapes
JSON_TEXTS = [
    '{"lr": 1e-5, "a": 1E+5, "b": 1.0e5, "c": 1.5e-3, "d": -0, "e": 1.5E+3, "f": 10E-1,'
    ' "g": 2.5E-3, "h": 1.0e+400, "i": 0.1, "j": -1.5, "k": 0}',
    '{"big": 123456789012345678901234567890, "neg": -98765432109876543210, "consts":'
    ' [NaN, Infinity, -Infinity]}',
    '{"s": "' + BS + 'u00e9' + BS + 'u4e2d' + BS + '/' + BS + 'n' + BS + 't' + BS + '"",'
    ' "raw": "é中 😀", "empty": ""}',
    '{\n  "model": {"depth": 24, "heads": [16, {"d": [true, false, null]}]},\n'
    '  "solver": {"lr": 2e-4, "steps": [30000, 40000]}\n}\n',
    '{"a": 1, "a": 2, "b": {"x": 1e-5, "x": 3}, "b.c": 4}',
    '{"model.depth":3,"lr":1e-5,"list":[1,2,{"c":-0.5}]}',
]


@pytest.mark.parametrize("i", range(len(JSON_TEXTS)))
def test_json_configs_read_as_yaml_safe_load(tmp_path, i):
    """A ``.json`` config reads as the JAX package reads it, through
    ``yaml.safe_load``: YAML 1.1 resolves ``1e-5`` (no dot), ``1E+5`` and
    ``1.0e5`` (unsigned exponent), ``NaN`` and ``Infinity`` as strings; big
    ints, escapes, nesting, and the last of duplicate keys as `json` does."""
    path = tmp_path / "c.json"
    path.write_text(JSON_TEXTS[i], encoding="utf-8")
    want = yaml.safe_load(JSON_TEXTS[i])
    assert same(want, yaml_subset.load_file(str(path))), want
    assert same(targs.load_opt_from_config_files([str(path)]),
                jargs.load_opt_from_config_files([str(path)]))
    with open(path, "rb") as f:
        assert same(tcfg.CfgNode.load_yaml_with_base(str(path)).to_dict(),
                    jcfg.CfgNode.load_yaml_with_base(str(path)).to_dict())


def test_json_reader_planted_fault_and_refusals(tmp_path, monkeypatch):
    """A plain ``json.load`` in place of the YAML reading gives ``lr`` 1e-05
    where the JAX package reads '1e-5', and the loaders' comparison fails;
    JSON that PyYAML reads otherwise (a surrogate-pair escape, a tab between
    tokens) raises `YAMLSubsetError`."""
    import json

    path = tmp_path / "c.json"
    path.write_text(JSON_TEXTS[0])
    want = jargs.load_opt_from_config_files([str(path)])
    assert want["lr"] == "1e-5"
    monkeypatch.setattr(yaml_subset, "load_json", json.loads)
    assert not same(targs.load_opt_from_config_files([str(path)]), want)
    monkeypatch.undo()
    for text, what in (('{"a": "' + BS + 'ud83d' + BS + 'ude00"}', "surrogate"),
                       ('{\n\t"a": 1}', "tab")):
        path.write_text(text)
        with pytest.raises(yaml_subset.YAMLSubsetError, match=what):
            yaml_subset.load_file(str(path))


def test_py_config_fromfile_with_base(tmp_path):
    (tmp_path / "base.py").write_text(
        "import os\nlr = 1e-4\nmodel = dict(depth=24, embed_dim=1024, heads=dict(n=16))\n"
        "epochs = 10\n_private = 1\ndef helper():\n    return 1\n")
    (tmp_path / "mid.py").write_text("_base_ = 'base.py'\nmodel = dict(heads=dict(d=64))\n")
    (tmp_path / "child.py").write_text(
        "_base_ = ['mid.py']\nmodel = dict(depth=12)\nwandb = False\n")
    cfg_t = tcfg.Config.fromfile(str(tmp_path / "child.py"))
    cfg_j = jcfg.Config.fromfile(str(tmp_path / "child.py"))
    assert dict(cfg_t) == dict(cfg_j)
    assert cfg_t.model.depth == 12 and cfg_t.model.embed_dim == 1024
    assert cfg_t.model.heads == {"n": 16, "d": 64} and cfg_t.get("missing", 3) == 3
    assert cfg_t.epochs == 10 and cfg_t.wandb is False and "helper" not in cfg_t
    with pytest.raises(AttributeError):
        cfg_t.nothing


def test_parse_configs_cli_override(tmp_path, monkeypatch):
    (tmp_path / "c.py").write_text("seed = 1\nnum_train_epochs = 5\n")
    for argv in (["--config", str(tmp_path / "c.py"), "--seed", "7"],
                 ["--config", str(tmp_path / "c.py"), "--wandb", "yes", "--local_rank", "2"]):
        assert dict(tcfg.parse_configs(argv)) == dict(jcfg.parse_configs(argv))
    monkeypatch.setenv("LOCAL_RANK", "3")
    argv = ["--config", str(tmp_path / "c.py")]
    assert vars(tcfg.parse_args(argv)) == vars(jcfg.parse_args(argv))
    for v in ("yes", "0", "T", "n", True):
        assert tcfg.str2bool(v) == jcfg.str2bool(v)
    with pytest.raises(Exception):
        tcfg.str2bool("maybe")


def test_cfgnode_yaml_base_and_merge(tmp_path):
    texts = {"root.yaml": "SOLVER:\n  LR: 0.001\n  STEPS: [10, 20]\nDATA: {NAME: a}\n",
             "base.yaml": "_BASE_: root.yaml\nMODEL:\n  DEPTH: 24\n  DIM: 1024\n",
             "exp.yaml": "_BASE_: base.yaml\nMODEL:\n  DEPTH: 12\nDATA:\n  ROOT: ~\n"}
    for name, text in texts.items():
        (tmp_path / name).write_text(text)
        assert_like_pyyaml(text)
    (tmp_path / "abs.yaml").write_text(f"_BASE_: {tmp_path / 'exp.yaml'}\nNEW: 1\n")
    for name in ("exp.yaml", "abs.yaml"):
        got = tcfg.CfgNode.load_yaml_with_base(str(tmp_path / name))
        want = jcfg.CfgNode.load_yaml_with_base(str(tmp_path / name))
        assert got.to_dict() == want.to_dict()
    cfg_t = tcfg.CfgNode.load_yaml_with_base(str(tmp_path / "exp.yaml"))
    cfg_j = jcfg.CfgNode.load_yaml_with_base(str(tmp_path / "exp.yaml"))
    for cfg, mod in ((cfg_t, tcfg), (cfg_j, jcfg)):
        cfg.merge_from_list(["SOLVER.LR", "0.01", "MODEL.HEADS", "16", "X.Y", "word"])
        cfg.merge_from_other_cfg(mod.CfgNode({"MODEL": {"DIM": 512}, "NEW": {"A": 1}}))
    assert cfg_t.to_dict() == cfg_j.to_dict()
    assert cfg_t.SOLVER.LR == 0.01 and cfg_t.MODEL.HEADS == 16 and cfg_t.X.Y == "word"
    c2 = cfg_t.clone()
    cfg_t.freeze()
    assert cfg_t.is_frozen() and cfg_t.MODEL.is_frozen()
    with pytest.raises(AttributeError):
        cfg_t.MODEL.DEPTH = 1
    cfg_t.defrost()
    cfg_t.MODEL.DEPTH = 1
    assert c2.MODEL.DEPTH == 12
    (tmp_path / "bad.yaml").write_text("_BASE_: exp.yaml\nA: &anchor 1\n")
    with pytest.raises(yaml_subset.YAMLSubsetError, match="line 2: an anchor"):
        tcfg.CfgNode.load_yaml_with_base(str(tmp_path / "bad.yaml"))


def test_loaders_and_converters_without_yaml_or_cv2(tmp_path):
    """The config loaders, the COLMAP converter (16-bit depth PNG) and the
    habitat remap run where ``import yaml`` and ``import cv2`` fail."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["yaml"] = None
        sys.modules["cv2"] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np, PIL.Image
        from iggt_official_tpu_torch.utils.arguments import load_opt_from_config_files
        from iggt_official_tpu_torch.utils.config_io import CfgNode
        from iggt_official_tpu_torch.data.colmap import Camera, Image, rotmat2qvec, write_model
        from iggt_official_tpu_torch.data.imread import imread_unchanged
        from iggt_official_tpu_torch.preprocess import convert_colmap_scene
        from iggt_official_tpu_torch.preprocess import habitat
        root = {str(tmp_path)!r}
        open(root + "/a.yaml", "w").write("_BASE_: b.yaml\\nA: {{x: 1}}\\n")
        open(root + "/b.yaml", "w").write("A:\\n  y: [2, 3]\\nm.n: 4\\n")
        assert CfgNode.load_yaml_with_base(root + "/a.yaml").to_dict() == \\
            {{"A": {{"y": [2, 3], "x": 1}}, "m.n": 4}}
        assert load_opt_from_config_files([root + "/b.yaml"]) == {{"A": {{"y": [2, 3]}}, "m": {{"n": 4}}}}
        import os
        os.makedirs(root + "/images")
        PIL.Image.new("RGB", (8, 6)).save(root + "/images/f.jpg")
        write_model({{1: Camera(1, "PINHOLE", 8, 6, np.array([5.0, 5, 4, 3]))}},
                    {{1: Image(1, rotmat2qvec(np.eye(3)), np.zeros(3), 1, "f.jpg",
                              np.zeros((0, 2)), np.zeros(0, np.int64))}}, {{}}, root + "/sparse")
        d = np.full((6, 8), 1.25, np.float32)
        assert convert_colmap_scene(root + "/sparse", root + "/images", root + "/out",
                                    depth_maps={{"f.jpg": d}}) == 1
        assert (imread_unchanged(root + "/out/seq0000/depth/000000.png") == 1250).all()
        eq = habitat.EquirectangularProjection(10, 20)
        crop = habitat.RotatedProjection(habitat.PerspectiveProjection(
            np.array([[4.0, 0, 4], [0, 4, 3], [0, 0, 1]]), 6, 8), None)
        col, depth, _ = habitat.extract_cropped_camera(
            eq, crop, np.zeros((10, 20, 3), np.uint8), np.ones((10, 20), np.float32),
            pixel_jittering_iterations=1)
        assert col.shape == (6, 8, 3) and depth.shape == (6, 8)
        for name in ("yaml", "cv2"):
            assert sys.modules[name] is None
        print("ran without yaml and cv2")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "ran without yaml and cv2" in out.stdout
