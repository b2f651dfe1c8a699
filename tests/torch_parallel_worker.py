"""One rank of the port's data-parallel tests (tests/test_torch_parallel_*.py).

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_parallel_worker.py TASK DIR

The environment is what torchrun gives a rank.  With WORLD_SIZE above 1 the
rank joins a gloo group on the CPU (`init_distributed(backend="gloo",
device="cpu")`); with 1 it runs alone, the one-process reference.  It runs
TASK on what DIR holds, with 2 torch threads, and writes its results to
DIR/TASK_w<world>_<rank>.pt (torch.save).  Imports no jax: the tests that
start it (through `Ranks`) compare its results with the JAX package's.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from saspa_tpu_torch.fgvc import train as ttrain  # noqa: E402
from saspa_tpu_torch.models.cal import WSDAN_CAL  # noqa: E402
from saspa_tpu_torch.models.layers import init_weights, sync_batch_norms  # noqa: E402
from saspa_tpu_torch.parallel import init_distributed, make_mesh, replicated, shard_batch  # noqa: E402
from saspa_tpu_torch.utils import rng as rngs  # noqa: E402
from saspa_tpu_torch.utils.config import get_train_config  # noqa: E402

CPU = torch.device("cpu")


def _load(path):
    return torch.load(path, weights_only=False)


# ---- the train step ----------------------------------------------------------
def f64_state(spec: dict, mesh) -> ttrain.TrainState:
    """A WSDAN-CAL TrainState in f64 on the CPU: spec's state_dict, or the
    seeded init; then rank 0's values on every rank and, under a mesh,
    BatchNorm over the global batch (as Trainer does)."""
    model = WSDAN_CAL(num_classes=spec["num_classes"], M=spec["M"], net=spec["net"], dtype=torch.float64,
                      device=CPU, param_dtype=torch.float64).to(torch.float64)
    if "state_dict" in spec:
        model.load_state_dict(spec["state_dict"])
    else:
        init_weights(model, spec["init_seed"])
    for p in model.parameters():
        p.requires_grad_(True)
    state = ttrain.TrainState(model=model, feature_center=spec.get("feature_center", torch.zeros(
        spec["num_classes"], spec["M"] * model.num_features, dtype=torch.float64)).clone(),
        momentum={n: torch.zeros_like(p) for n, p in model.named_parameters()})
    if mesh is not None:
        replicated(mesh, [state.model, state.feature_center, state.momentum])
        sync_batch_norms(state.model, mesh)
    return state


def _record(state, m) -> dict:
    sd = state.model.state_dict()
    stats = {k: v.clone() for k, v in sd.items() if k.endswith((".mean", ".var"))}
    return {"metrics": {k: v.clone() for k, v in m.items()}, "batch_stats": stats,
            "feature_center": state.feature_center.clone(), "step": state.step}


def _final(state, mesh) -> dict:
    """Params and momentum after the last step (rank 0 keeps them), and
    every other rank's largest difference from rank 0's."""
    params = {k: v.detach().clone() for k, v in state.model.named_parameters()}
    momentum = {k: v.clone() for k, v in state.momentum.items()}
    if mesh is None or mesh.rank == 0:
        out = {"params": params, "momentum": momentum}
    else:
        out = {}
    if mesh is not None:
        import torch.distributed as dist

        diff = 0.0
        for t in list(params.values()) + list(momentum.values()) + list(state.model.buffers()):
            ref = t.clone()
            dist.broadcast(ref, 0)
            diff = max(diff, float((ref - t).abs().max()))
        out["max_diff_from_rank0"] = diff
    return out


def train_injected(d: Path, mesh) -> dict:
    """Steps of the injected-draw train step on the global batches of
    DIR/train_in.pt (NCHW f64 X, int y, global draws), each rank on its rows."""
    spec = _load(d / "train_in.pt")
    state = f64_state(spec, mesh)
    cfg = get_train_config("planes").replace(**spec["cfg"])
    step = ttrain.make_train_step(cfg, 10, mesh)
    steps = []
    for s, (X, y, draws) in enumerate(spec["batches"]):
        if mesh is not None:
            X, y = shard_batch(mesh, (X, y))
        m = step(state, X, y, np.asarray(spec["keys"][s], np.uint32), draws=draws)
        steps.append(_record(state, m))
    return {"steps": steps, **_final(state, mesh)}


class _Files:
    """A train split's file list, as data.datasets' readers give it."""

    dataset_name = "planes"

    def __init__(self, image_files, labels, classes):
        self.image_files, self.labels, self.classes = image_files, labels, classes

    @property
    def num_classes(self):
        return len(self.classes)


def train_keyed(d: Path, mesh) -> dict:
    """Keyed steps on the batches of a CutMix recipe through InputPipeline
    (AugSampler on): each rank loads and transforms its rows only."""
    from saspa_tpu_torch.data.datasets import FGVCDataset
    from saspa_tpu_torch.data.pipeline import InputPipeline

    spec = _load(d / "keyed_in.pt")
    ds = FGVCDataset(_Files(spec["files"], spec["labels"], spec["classes"]), "train", aug_json=spec["aug_json"],
                     aug_sample_ratio=0.5, seed=3, print_func=lambda *a: None)
    pipe = InputPipeline(ds, batch_size=spec["batch_size"], resize=spec["resize"], train_transform=spec["preset"],
                         use_cutmix=True, seed=5, num_threads=2, device="cpu", mesh=mesh)
    state = f64_state(spec, mesh)
    cfg = get_train_config("planes").replace(**spec["cfg"])
    step = ttrain.make_train_step(cfg, len(pipe), mesh)
    steps, batches = [], []
    for i, (X, y, y_soft) in enumerate(pipe.iter_train(spec["epoch"])):
        batches.append({"X": X.clone(), "y": y.clone(), "y_soft": y_soft.clone()})
        m = step(state, X.double(), y, rngs.item_key(5, "dropout", spec["epoch"], i), y_soft=y_soft.double())
        steps.append(_record(state, m))
    loaded = [spec["batch_size"] if pipe.own is None else len(pipe._sources(spec["epoch"], i, True))
              for i in range(len(steps))]
    return {"steps": steps, "batches": batches, "loaded": loaded,
            "swaps": (ds.aug_sampler.times_used_aug_images, ds.aug_sampler.times_used_orig_images),
            **_final(state, mesh)}


# ---- the filters -------------------------------------------------------------
def tiny_scorers():
    """The real scorers with their towers cut to one block a stage and
    narrow widths, on the CPU (tests/test_torch_filters.py's tiny_scorers)."""
    from saspa_tpu_torch.filters import clip_filters, confidence
    from saspa_tpu_torch.models import resnet
    from saspa_tpu_torch.models.clip import CLIPVisionRNConfig
    from saspa_tpu_torch.models.text_encoder import CLIPTextConfig

    clip_filters.VISION_CFG = CLIPVisionRNConfig(layers=(1, 1, 1, 1), width=16, output_dim=32)
    clip_filters.TEXT_CFG = CLIPTextConfig(width=32, layers=2, heads=2, projection_dim=32)
    resnet.BACKBONES["resnet101"] = partial(resnet.ResNet, stage_sizes=(1, 1, 1, 1))
    clip_filters.resolve_device = confidence.resolve_device = lambda device=None: CPU


def _count_scored(log: list):
    """Wraps both scorers' score_in_batches to note the rows this rank scored."""
    from saspa_tpu_torch.filters import batches, clip_filters, confidence

    def counted(paths, preprocess, forward, batch_size, width, device, timings=None, mesh=None):
        t = batches.new_timings()
        out = batches.score_in_batches(paths, preprocess, forward, batch_size, width, device, t, mesh)
        for k, v in t.items():
            if timings is not None:
                timings[k] += v
        log.append({"paths": len(paths), "scored": t["images"], "batches": t["batches"], "sharded": mesh is not None})
        return out

    clip_filters.score_in_batches = confidence.score_in_batches = counted


def score(d: Path, mesh) -> dict:
    """Both scorers over DIR's PNGs in batches of 8 (the tail padded)."""
    from saspa_tpu_torch.filters.batches import new_timings
    from saspa_tpu_torch.filters.clip_filters import CLIPScorer
    from saspa_tpu_torch.filters.confidence import batched_logits, load_cal_baseline

    tiny_scorers()
    paths = sorted(str(p) for p in (d / "imgs").glob("*.png"))
    scorer = CLIPScorer("rn50", device=CPU)
    model, preprocess = load_cal_baseline("planes", 5, device=CPU)
    t_clip, t_cal = new_timings(), new_timings()
    return {"clip": scorer.image_features(paths, 8, t_clip, mesh=mesh),
            "cal": batched_logits(model, paths, preprocess, 8, t_cal, mesh=mesh),
            "timings": {"clip": t_clip, "cal": t_cal}}


def cli_filter(d: Path, mesh) -> dict:
    """`cli filter` on the aug folder DIR/aug_folder.txt names, in batches
    of 2, as torchrun would run it."""
    from saspa_tpu_torch import cli

    tiny_scorers()
    log: list = []
    _count_scored(log)
    path = cli.main(["filter", "--dataset", "planes", "--aug_folder", (d / "aug_folder.txt").read_text(),
                     "--batch_size", "2"])
    return {"path": path, "scored": log}


def gen_filter(d: Path, mesh) -> dict:
    """run_generation_and_filter on the tiny SD1.5 + canny pipeline of
    DIR/pipe.pt: every rank generates its share, rank 0 filters alone."""
    from saspa_tpu_torch.diffusion.pipelines import DiffusionPipeline
    from saspa_tpu_torch.gen import driver
    from saspa_tpu_torch.utils.config import GenerationConfig

    tiny_scorers()
    log: list = []
    _count_scored(log)
    spec = _load(d / "pipe.pt")
    unet_cfg, vae_cfg, text_cfgs = spec["cfgs"]
    pipe = DiffusionPipeline(controlnet="canny", device="cpu", dtype=torch.float32, init_seed=None,
                             unet_cfg=unet_cfg, vae_cfg=vae_cfg, text_cfgs=text_cfgs)
    pipe.load_flax_params(spec["params"])
    cfg = GenerationConfig(dataset="planes", num_per_image=2, resolution=64, num_inference_steps=2, batch_size=4)
    path = driver.run_generation_and_filter(cfg, pipe=pipe, semantic_filtering=True,
                                            model_confidence_based_filtering=True)
    return {"path": path, "scored": log}


def cli_train(d: Path, mesh) -> dict:
    """`cli train` (one planes epoch of ResNet-50 at 64^2, global batch 2,
    the preset's f32) on the tree at $SASPA_DATA_ROOT, on the CPU."""
    from saspa_tpu_torch import cli
    from saspa_tpu_torch.utils import config

    config._TRAIN_PRESETS["planes"] = {**config._TRAIN_PRESETS["planes"], "image_size": (64, 64)}
    world = 1 if mesh is None else mesh.size
    args = cli.build_parser().parse_args(
        ["train", "--dataset", "planes", "--aug_json", str(d / "tree" / "aug.json"), "--aug_sample_ratio", "0.4",
         "--limit_aug_per_image", "2", "--special_aug", "classic", "--epochs", "1", "--batch_size", "2",
         "--net", "resnet50", "--seed", "1", "--learning_rate", "1e-6", "--logdir", str(d / f"logs_w{world}" / "run")])
    logs = cli.cmd_train(args, device="cpu")
    return {k: v for k, v in logs.items() if k != "restored"}


# ---- the (data, model) grid: the column-parallel head and the dry run ---------------
def _max_diff(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def _bit_diffs(state, grid) -> dict:
    """After the last step: the largest difference of each rank's replicated
    tensors (every parameter, momentum and buffer but fc's, the feature
    centers) from rank 0's, and of its fc shard and fc momentum from its
    model index's rank at data index 0 (broadcasts, world and data group)."""
    import torch.distributed as dist

    from saspa_tpu_torch.parallel import data_group

    fc = [state.model.fc.kernel.detach(), state.momentum["fc.kernel"]]
    rep = ([p.detach() for n, p in state.model.named_parameters() if n != "fc.kernel"]
           + [v for n, v in state.momentum.items() if n != "fc.kernel"] + list(state.model.buffers())
           + [state.feature_center])
    out = {"replicated": 0.0, "shard": 0.0}
    for key, tensors, src, group in (("replicated", rep, 0, None), ("shard", fc, grid.model_index, data_group(grid))):
        for t in tensors:
            ref = t.clone()
            dist.broadcast(ref, src, group=group)
            out[key] = max(out[key], _max_diff(ref, t))
    return out


def _sharded_steps(spec, cfg, mesh) -> tuple:
    """The injected-draw steps of spec on `mesh` (None: one process), the
    head sharded over a model axis; every step's record with the whole fc
    and its momentum, the gradient sgd_update takes (fc's reassembled) on
    rank 0, and after step 1 rank 0's params and momentum (fc's whole)."""
    from saspa_tpu_torch.parallel import shard_head

    state = f64_state(spec, mesh)
    if mesh is not None:
        shard_head(state.model, mesh, state.momentum)
    fc = state.model.fc
    whole = (lambda t: fc.gather(t)) if mesh is not None and mesh.model_size > 1 else (lambda t: t.clone())
    lead = mesh is None or mesh.rank == 0
    step = ttrain.make_train_step(cfg, 10, mesh)
    grads, real = [], ttrain.sgd_update

    def spy(st, *a):
        g = {n: (whole(p.grad) if n == "fc.kernel" else p.grad.clone()) for n, p in st.model.named_parameters()}
        grads.append(g if lead else None)
        return real(st, *a)

    ttrain.sgd_update = spy
    steps = []
    try:
        for s, (X, y, draws) in enumerate(spec["batches"]):
            if mesh is not None:
                X, y = shard_batch(mesh, (X, y))
            m = step(state, X, y, np.asarray(spec["keys"][s], np.uint32), draws=draws)
            rec = _record(state, m)
            rec.update(fc=whole(state.model.fc.kernel.detach()), fc_momentum=whole(state.momentum["fc.kernel"]))
            if s == 0 and lead:
                rec["params"] = {n: (rec["fc"] if n == "fc.kernel" else p.detach().clone())
                                 for n, p in state.model.named_parameters()}
                rec["momentum"] = {n: (rec["fc_momentum"] if n == "fc.kernel" else v.clone())
                                   for n, v in state.momentum.items()}
            steps.append(rec)
    finally:
        ttrain.sgd_update = real
    return state, steps, grads


def _trainer_epoch(spec: dict, mesh, d: Path) -> dict:
    """Trainer(mesh=`mesh`) (None: one process) through one epoch of
    InputPipeline(mesh=...) batches of spec's files, its evaluation on them
    and its best checkpoint (DIR/trainer_best_<rank>.pt), in f64: every rank
    but rank 0 starts from another seed, so only replicated() makes them
    one.  Returns the epoch's and the evaluation's logs, this rank's train
    batch, and the state (_record's and _final's)."""
    from saspa_tpu_torch.data.datasets import FGVCDataset
    from saspa_tpu_torch.data.pipeline import InputPipeline

    rank = 0 if mesh is None else mesh.rank
    cfg = get_train_config("planes").replace(**spec["cfg"])
    files = _Files(spec["files"], spec["labels"], spec["classes"])
    pipes = [InputPipeline(FGVCDataset(files, split, seed=3, print_func=lambda *a: None),
                           batch_size=cfg.batch_size, resize=cfg.image_size, train_transform="classic", seed=5,
                           num_threads=2, device="cpu", mesh=mesh) for split in ("train", "test")]
    real = ttrain.create_train_state
    ttrain.create_train_state = lambda c, n, device=None, init_seed=None: f64_state(
        {"num_classes": n, "M": c.num_attentions, "net": c.net, "init_seed": rank}, None)
    try:
        trainer = ttrain.Trainer(cfg, len(spec["classes"]), len(pipes[0]), CPU, mesh=mesh)
    finally:
        ttrain.create_train_state = real
    batches = [(X.double(), y, y_soft) for X, y, y_soft in pipes[0].iter_train(0)]
    train = trainer.run_epoch(0, batches)
    val = trainer.evaluate((X.double(), y) for X, y in pipes[1].iter_eval())
    saved = trainer.maybe_save_best(val["val_topk_accuracy"][0], str(d / f"trainer_best_{rank}.pt"))
    return {"train": train, "val": val, "saved": saved, "X": batches[0][0], "y": batches[0][1],
            **_record(trainer.state, {}), **_final(trainer.state, mesh)}


def tp(d: Path, mesh) -> dict:
    """On 4 ranks as a (2, 2) mesh: the f64 injected-draw steps of
    DIR/train_in.pt with the head sharded over the model axis; then, on
    rank 0 alone (no collective), the same steps in one process, and each
    step's gradient error against them; the ranks' bit differences; a
    Trainer epoch on the grid (everything replicated) and, on rank 0, in one
    process; the dry run's three stages (dryrun_multichip(4)), and on rank 0
    stages 2 and 3 in one process."""
    from saspa_tpu_torch import dryrun
    from saspa_tpu_torch.fgvc.train import create_train_state
    from saspa_tpu_torch.parallel import make_mesh
    from saspa_tpu_torch.parallel.mesh import Mesh

    spec = _load(d / "train_in.pt")
    cfg = get_train_config("planes").replace(**spec["cfg"])
    grid = make_mesh((2, 2))
    state, steps, grads = _sharded_steps(spec, cfg, grid)
    out = {"coords": (grid.data_index, grid.model_index), "steps": steps, "shard": state.model.fc.kernel.detach(),
           "bit_diffs": _bit_diffs(state, grid)}
    one = Mesh((1, 1), ("data", "model"), 0, CPU)
    if grid.rank == 0:
        _, out["one_steps"], ref_grads = _sharded_steps(spec, cfg, None)
        flat = [(torch.cat([g[n].reshape(-1) for n in r]), torch.cat([v.reshape(-1) for v in r.values()]))
                for g, r in zip(grads, ref_grads)]
        out["grad_rel"] = [float((g - r).norm() / r.norm()) for g, r in flat]
    out["trainer"] = _trainer_epoch(spec["trainer"], grid, d)
    if grid.rank == 0:
        out["trainer_one"] = _trainer_epoch(spec["trainer"], None, d / "one")
    out["dryrun"] = dryrun.dryrun_multichip(4, "cpu")
    if grid.rank == 0:
        n = 4
        model = create_train_state(dryrun.train_config(n), dryrun.NUM_CLASSES, CPU, init_seed=0).model.eval()
        out["one"] = {"generation": dryrun.generation_stage(n, one, CPU), "filter": dryrun.filter_stage(n, one, model)}
    return out


TASKS = {"tp": tp, "train_injected": train_injected, "train_keyed": train_keyed, "score": score,
         "cli_filter": cli_filter, "gen_filter": gen_filter, "cli_train": cli_train}


# ---- the launcher the tests call ----------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` processes running TASK on DIR, started as torchrun starts its
    ranks (on 127.0.0.1 and a free port), each with its log in DIR.
    `results()` waits for all of them, at most `timeout` seconds: on time
    out it kills them all and fails with their logs, and it fails with the
    logs when a rank exits with an error."""

    def __init__(self, task: str, d: Path, world: int = 2, timeout: float = 300, env=None):
        self.task, self.d, self.world, self.timeout = task, Path(d), world, timeout
        port = _free_port()
        self.logs, self.procs = [], []
        for r in range(world):
            e = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), OMP_NUM_THREADS="2")
            e.update(env or {})
            log = self.d / f"{task}_w{world}_{r}.log"
            self.logs.append(log)
            with open(log, "w") as fh:
                self.procs.append(subprocess.Popen([sys.executable, __file__, task, str(self.d)], cwd=str(REPO),
                                                   env=e, stdout=fh, stderr=subprocess.STDOUT))
        self.t0 = time.monotonic()

    def _tails(self) -> str:
        return "\n---\n".join(f"{log.name}:\n{log.read_text()[-3000:]}" for log in self.logs)

    def results(self) -> list:
        import pytest

        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.timeout - (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            for p in self.procs:
                p.wait()
            pytest.fail(f"{self.task} ranks timed out after {self.timeout} s:\n{self._tails()}")
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            pytest.fail(f"{self.task} ranks {bad} failed:\n{self._tails()}")
        return [_load(self.d / f"{self.task}_w{self.world}_{r}.pt") for r in range(self.world)]

    def log_texts(self) -> list:
        return [log.read_text() for log in self.logs]


def main(task: str, d: str):
    import logging

    torch.set_num_threads(2)
    logging.basicConfig(level=logging.INFO)
    d = Path(d)
    world = init_distributed(backend="gloo", device="cpu")
    mesh = make_mesh() if world > 1 else None
    rank = 0 if mesh is None else mesh.rank
    out = TASKS[task](d, mesh)
    torch.save(out, d / f"{task}_w{world}_{rank}.pt")
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
