"""`run_generation_and_filter` on 2 real ranks against one process, on the
CPU: the port's counterpart of tests/test_multihost_real.py.

Each run (tests/torch_parallel_worker.py `gen_filter`) has its own copy of
one FGVC-Aircraft tree (3 sources) and drives the tiny SD1.5 + canny
pipeline (tests/test_torch_pipeline.py's tiny_params) at 64^2, 2 DDIM steps,
2 images a source, batch 4, then the recipe's filters with the scorers'
towers cut narrow.  Under gloo the ranks split the worklist and meet at the
barrier; rank 0 alone scores, unsharded on its own device, and writes the
aug-JSON, as the JAX driver does.  The union of the two ranks' PNGs is
byte-identical to the one-process run's, and the JSON, written once, lists
the same files.
"""

import json
from pathlib import Path

import torch

from tests.test_torch_filters import _planes_tree
from tests.test_torch_pipeline import P_TEXT, P_UNET, P_VAE, tiny_params
from tests.torch_parallel_worker import Ranks


def _pngs(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*.png"))}


def test_run_generation_and_filter_over_two_ranks_equals_one(tmp_path):
    torch.save({"cfgs": (P_UNET, P_VAE, P_TEXT), "params": tiny_params()}, tmp_path / "pipe.pt")
    runs = {}
    for tag, world in (("one", 1), ("two", 2)):
        _planes_tree(tmp_path / tag, size=96)
        before = set(_pngs(tmp_path / tag))
        env = {"SASPA_DATA_ROOT": str(tmp_path / tag), "SASPA_CHECKPOINTS": str(tmp_path / "no_checkpoints"),
               "SASPA_STRICT_WEIGHTS": "", "SASPA_WEIGHTS_DIR": ""}
        runs[tag] = (Ranks("gen_filter", tmp_path, world=world, env=env, timeout=360), before)
    (one,) = runs["one"][0].results()
    two = runs["two"][0].results()
    logs = runs["two"][0].log_texts()

    made = {tag: {k: v for k, v in _pngs(tmp_path / tag).items() if k not in before}
            for tag, (_, before) in runs.items()}
    gen = [k for k in made["one"] if "_prompt_" in Path(k).name]
    assert len(gen) == 6 and len(made["one"]) == 12 and made["two"] == made["one"]  # names and bytes, side files too
    assert two[0]["path"] == two[1]["path"] and Path(two[0]["path"]).exists()
    assert Path(one["path"]).relative_to(tmp_path / "one") == Path(two[0]["path"]).relative_to(tmp_path / "two")
    want = json.loads(Path(one["path"]).read_text().replace(str(tmp_path / "one"), str(tmp_path / "two")))
    assert json.loads(Path(two[0]["path"]).read_text()) == want
    assert [log.count("Finished writing") for log in logs] == [1, 0]
    assert two[1]["scored"] == [] and all(not s["sharded"] and s["scored"] == 6 for s in two[0]["scored"])
