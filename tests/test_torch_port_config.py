"""The port's ``config.py`` against the JAX package's.

Everything here is exact: the ``Args`` fields (name, default, type), the
two generated parsers action for action, the parse of the same command
lines, the bytes of ``params.txt`` and of ``save_args``' JSON,
``IGNORED_FLAGS``' keys and what ``warn_ignored_flags`` hits. The port's
``RunState`` is JAX's with the loop's ``meters`` added. And the port's
package imports nothing of JAX.
"""

import argparse
import dataclasses
import logging
import os
import re

import pytest
import torch

from mamba_clip_tpu import config as jcfg
from mamba_clip_tpu_torch import config as tcfg
from mamba_clip_tpu_torch.cli import main as tmain

# The plain paths are Python loops of small tensor ops: one intra-op thread
# runs them as fast as eight alone, and keeps them from stalling (up to ten
# times slower) when the test workers share the machine's cores.
torch.set_num_threads(1)

PORT_SRC = os.path.join(os.path.dirname(__file__), "..", "src", "mamba_clip_tpu_torch")


def _default(f):
    if f.default is not dataclasses.MISSING:
        return f.default
    return f.default_factory()


def _every_flag_argv():
    """One command line that sets every flag away from its default."""
    argv = []
    for f in dataclasses.fields(jcfg.Args):
        name = "--" + f.name.replace("_", "-")
        d = _default(f)
        t = str(f.type)
        if t == "bool":
            argv.append("--no-" + name[2:] if d else name)
        elif "List[float]" in t:
            argv += [name, "0.25", "0.5", "0.75"]
        elif "List[int]" in t:
            argv += [name, "48"]
        elif "List[str]" in t:
            argv += [name, "scale=0.4,1.0", "hflip=0.3"]
        elif "int" in t:
            argv += [name, "7"]
        elif "float" in t:
            argv += [name, "0.125"]
        else:
            argv += [name, f"value_of_{f.name}"]
    return argv


ARGVS = {
    "empty": [],
    "readme_quick_start": ["--data-path", "<path_to_data>", "--logs", "./logs/",
                           "--batch-size", "64", "--epochs", "10"],
    "readme_flagship": [
        "--data-path", "./data/isic-2024-challenge/", "--logs", "./logs/",
        "--batch-size", "64", "--epochs", "10", "--lr", "1e-4", "--precision", "amp",
        "--model-stage-1", "microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224",
        "--model-stage-2", "ClipClassifier",
        "--tokenizer", "hf-hub:microsoft/BiomedCLIP-PubMedBERT_256-vit_base_patch16_224"],
    "drive_recipe": ["--synthetic-data", "--train-num-samples", "192", "--val-num-samples", "64",
                     "--batch-size", "64", "--epochs", "1", "--warmup", "2", "--lr", "1e-4",
                     "--precision", "amp", "--save-most-recent", "--log-every-n-steps", "1",
                     "--grad-clip-norm", "1.0", "--attn-impl", "flash", "--logs", "/tmp/x"],
    "every_flag": _every_flag_argv(),
}


def test_args_fields_defaults_and_types_equal_jax():
    jf, tf = dataclasses.fields(jcfg.Args), dataclasses.fields(tcfg.Args)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(jf, tf):
        assert str(b.type) == str(a.type), a.name
        assert _default(b) == _default(a) and type(_default(b)) is type(_default(a)), a.name
    assert tcfg.Args().dist_backend == "jax"


def _actions(parser):
    return [(a.option_strings, a.dest, a.nargs, a.type, a.default, a.const, a.required,
             type(a).__name__) for a in parser._actions if not isinstance(a, argparse._HelpAction)]


def test_parsers_agree_action_for_action():
    ja, ta = _actions(jcfg.arg_parser()), _actions(tcfg.arg_parser())
    assert len(ta) == len(ja) > 100
    for a, b in zip(ja, ta):
        assert b == a
    assert tmain.arg_parser is tcfg.arg_parser


@pytest.mark.parametrize("which", sorted(ARGVS))
def test_same_command_lines_parse_to_equal_args(which):
    argv = ARGVS[which]
    got, want = tcfg.parse_args(argv).to_dict(), jcfg.parse_args(argv).to_dict()
    assert got == want
    if which == "every_flag":
        assert all(got[k] != v for k, v in jcfg.Args().to_dict().items())


def test_params_txt_and_json_are_byte_equal(tmp_path):
    argv = ARGVS["every_flag"]
    ja, ta = jcfg.parse_args(argv), tcfg.parse_args(argv)
    ja.dump(str(tmp_path / "j.txt"))
    ta.dump(str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    jcfg.save_args(ja, str(tmp_path / "j.json"))
    tcfg.save_args(ta, str(tmp_path / "t.json"))
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert tcfg.load_args(str(tmp_path / "j.json")) == ta
    assert tcfg.args_from_dict({**ta.to_dict(), "unknown": 1}) == ta
    assert ta.replace(seed=5).seed == 5 and ta.seed == 7


def test_ignored_flags_and_their_warnings():
    # the port's ranks take --dist-url and --dist-backend (parallel/mesh.py);
    # JAX ignores them
    assert set(tcfg.IGNORED_FLAGS) == set(jcfg.IGNORED_FLAGS) - {"dist_url", "dist_backend"}
    assert not any("tpu" in why.lower() for why in tcfg.IGNORED_FLAGS.values())
    log = logging.getLogger("test-port-ignored")
    kw = dict(horovod=True, torchcompile=True, dist_backend="nccl", zero_shot=True)
    hit_t = tcfg.warn_ignored_flags(tcfg.Args(**kw), log)
    hit_j = jcfg.warn_ignored_flags(jcfg.Args(**kw), log)
    assert hit_t == [k for k in hit_j if k != "dist_backend"]
    assert set(hit_j) == set(kw)
    assert tcfg.warn_ignored_flags(tcfg.Args(), log) == []


def test_run_state_is_jax_s_plus_the_meters():
    jf = [(f.name, _default(f)) for f in dataclasses.fields(jcfg.RunState)]
    tf = [(f.name, _default(f)) for f in dataclasses.fields(tcfg.RunState)]
    assert [n for n, _ in tf] == [n for n, _ in jf] + ["meters"]
    assert {n: d for n, d in tf if n != "device"} == {
        **{n: d for n, d in jf if n != "device"}, "meters": {}}


def test_the_port_imports_nothing_of_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|mamba_clip_tpu)\b", re.M)
    hits = []
    for root, _, files in os.walk(PORT_SRC):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                hits += [(path, m.group(0)) for m in pat.finditer(open(path).read())]
    chip_smoke = os.path.join(PORT_SRC, "..", "..", "chip_smoke.py")
    hits += [(chip_smoke, m.group(0)) for m in pat.finditer(open(chip_smoke).read())]
    assert hits == []
