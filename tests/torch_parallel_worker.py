"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py,
tests/test_torch_cli.py, tests/test_torch_train_cli.py), and the cases they
run in one process for reference.

    python tests/torch_parallel_worker.py JOB DIR RANK WORLD

joins a gloo group through the file store ``DIR/store`` (no TCP port), one
torch thread a rank, serves the so3/torus tables the test wrote to
``DIR/tables.pt``, runs JOB on the inputs in ``DIR/inputs.pt`` and saves what
it returns to ``DIR/out{RANK}.pt``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

from confidence_bootstrapping_tpu_torch.config import SamplerConfig, ScoreModelConfig, TrainConfig
from confidence_bootstrapping_tpu_torch.data.complex_graph import ComplexBatch
from confidence_bootstrapping_tpu_torch.models.score_model import TensorProductScoreModel
from confidence_bootstrapping_tpu_torch.ops import so3, torus
from confidence_bootstrapping_tpu_torch.parallel import mesh as meshlib
from confidence_bootstrapping_tpu_torch.sampler import sampling
from confidence_bootstrapping_tpu_torch.train import train_loop

LR = 1e-3


def serve_tables(tables: dict) -> None:
    """The port's so3/torus lookups from the given tensors (the JAX tables
    the test installed), so no rank builds a table."""
    so3._table = lambda device: tables["so3_norm"].to(device)
    so3._grids = lambda device: (tables["so3_cdf"].to(device), tables["so3_score"].to(device))
    torus._table = lambda device: tables["torus_norm"].to(device)
    torus._score_table = lambda device: tables["torus_score"].to(device)


def tables_of_the_port(device="cpu") -> dict:
    """The tables the port serves on ``device`` now (on the CPU after
    ``install_jax_tables``; on the card it builds them there), as host
    tensors."""
    dev = torch.device(device)
    cdf, score = so3._grids(dev)
    tables = dict(so3_norm=so3._table(dev), so3_cdf=cdf, so3_score=score, torus_norm=torus._table(dev),
                  torus_score=torus._score_table(dev))
    return {k: v.cpu() for k, v in tables.items()}


def batch_of(fields: dict, device="cpu") -> ComplexBatch:
    return ComplexBatch(**{k: None if fields.get(k) is None else fields[k].to(device)
                           for k in ComplexBatch.__dataclass_fields__})


def fields_of(batch: ComplexBatch) -> dict:
    return {k: getattr(batch, k) for k in ComplexBatch.__dataclass_fields__ if getattr(batch, k) is not None}


@contextlib.contextmanager
def captured_gradients(into: list, params: list = None):
    """Record the gradients each step hands ``apply_gradients`` and, given
    ``params``, the parameters before and after the step (a pair a step)."""
    real = train_loop.apply_gradients

    def spy(state, grads, *a, **k):
        into.append([g.detach().clone() if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, state.model.parameters())])
        before = [p.detach().clone() for p in state.model.parameters()]
        out = real(state, grads, *a, **k)
        if params is not None:
            params.append((before, [p.detach().clone() for p in state.model.parameters()]))
        return out

    train_loop.apply_gradients = spy
    try:
        yield
    finally:
        train_loop.apply_gradients = real


def _model(inp: dict, **overrides):
    cfg = ScoreModelConfig(**{**inp["cfg"], **overrides})
    model = TensorProductScoreModel(cfg, device=inp.get("device", "cpu"))
    model.load_state_dict(inp["state"])
    return model, cfg


def _gen(inp: dict, seed: int) -> torch.Generator:
    return torch.Generator(device=inp.get("device", "cpu")).manual_seed(seed)


def _cpu(d: dict) -> dict:
    return {k: v.detach().cpu() for k, v in d.items()}


def _step_result(state, metrics, grads) -> dict:
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=_cpu({n: g for (n, _), g in zip(state.model.named_parameters(), grads)}),
                params=_cpu(dict(state.model.named_parameters())), buffers=_cpu(dict(state.model.named_buffers())))


def train_case(inp: dict, mesh) -> dict:
    """One score-model step at dropout 0 and at 0.1, one torsional step,
    on the global batch ``inp["batch"]``; ``mesh`` None: one process."""
    out = {}
    batch = batch_of(inp["batch"], inp.get("device", "cpu"))
    for dropout in (0.0, 0.1):
        model, cfg = _model(inp, dropout=dropout)
        state = train_loop.init_train_state(model, TrainConfig(lr=LR))
        grads = []
        with captured_gradients(grads):
            m = train_loop.make_train_step(cfg, TrainConfig(lr=LR), mesh)(state, batch, _gen(inp, 7))
        out[f"score{dropout}"] = _step_result(state, m, grads[0])
    model, cfg = _model(inp, dropout=0.0)
    state = train_loop.init_train_state(model, TrainConfig(lr=LR))
    grads = []
    with captured_gradients(grads):
        m = train_loop.make_torsional_train_step(cfg, TrainConfig(lr=LR), mesh)(state, batch, _gen(inp, 7))
    out["torsional"] = _step_result(state, m, grads[0])
    return out


SAMPLERS = dict(
    sde=SamplerConfig(inference_steps=3),
    plan=SamplerConfig(inference_steps=3, rec_phase_steps=(1,), rec_phase_caps=(8,)),
    svgd=SamplerConfig(inference_steps=3, svgd_weight_log_0=-1.0, svgd_weight_log_1=-1.0,
                       svgd_repulsive_weight_log_0=0.0, svgd_repulsive_weight_log_1=0.0),
)


def permuted(batch: ComplexBatch, perm: torch.Tensor) -> ComplexBatch:
    """``batch`` with its rows (poses) in ``perm``'s order."""
    fields = fields_of(batch)
    assert all(v.shape[0] == batch.batch_size for v in fields.values())
    return batch_of({k: v[perm] for k, v in fields.items()})


@contextlib.contextmanager
def rows_follow(perm: torch.Tensor):
    """Every row draw of the sampler (``mesh.rows``) with its rows in
    ``perm``'s order: a batch permuted by ``perm`` gets each pose's own
    noise, so only the order of the sums over poses changes."""
    real = meshlib.rows
    meshlib.rows = lambda *a, **k: real(*a, **k)[perm]
    try:
        yield
    finally:
        meshlib.rows = real


@contextlib.contextmanager
def rank_rows(model, parts: int):
    """In one process, the receptor embedding and every forward of ``model``
    run on each of ``parts`` ranks' rows of the batch apart (the rows a
    ``parts``-rank mesh gives each rank), then put together: the ranks'
    arithmetic with the sampler's sums over the whole batch as one process
    makes them. The CPU's matrix products round a row by the number of
    rows, so this is how far the ranks' forwards alone move a sample."""
    real_forward, real_cache = model.forward, sampling.receptor_cache

    def pieces(batch):
        n = batch.batch_size // parts
        return [slice(i * n, (i + 1) * n) for i in range(parts)]

    def joined(outs):
        return type(outs[0])(*(torch.cat(x) if torch.is_tensor(x[0]) else x[0] for x in zip(*outs)))

    def cache(m, batch, shared=True):
        outs = [real_cache(m, batch.map(lambda a: a[s]), shared) for s in pieces(batch)]
        return None if outs[0] is None else joined(outs)

    def forward(batch, *a, rec_cache=None, **k):
        return joined([real_forward(batch.map(lambda t: t[s]), *a, rec_cache=None if rec_cache is None else
                                    type(rec_cache)(*(c[s] for c in rec_cache)), **k) for s in pieces(batch)])

    model.forward, sampling.receptor_cache = forward, cache
    try:
        yield
    finally:
        del model.forward
        sampling.receptor_cache = real_cache


def sample_case(inp: dict, mesh, names=tuple(SAMPLERS), perm=None, parts=None) -> dict:
    """The prior and a 3-step sample of the global batch under each sampler
    config (plain SDE, a phase plan, SVGD) of ``names``. One process only:
    with ``perm``, the same sample with the poses in ``perm``'s order, each
    with its own noise, put back in the batch's order; with ``parts``, with
    the forwards on ``parts`` ranks' rows apart (``rank_rows``)."""
    model, cfg = _model(inp)
    batch = batch_of(inp["batch"])
    out = {}
    for name in names:
        gen = torch.Generator().manual_seed(11)
        b = sampling.randomize_position(batch, gen, cfg.sigma.tr_sigma_max)
        if perm is None:
            with rank_rows(model, parts) if parts else contextlib.nullcontext():
                final, traj = sampling.sample(model, b, cfg, SAMPLERS[name], gen, return_trajectory=True,
                                              device="cpu", mesh=mesh)
            out[name] = dict(pos=final.lig_pos, traj=traj)
            continue
        with rows_follow(perm):
            final, traj = sampling.sample(model, permuted(b, perm), cfg, SAMPLERS[name], gen,
                                          return_trajectory=True, device="cpu")
        back = torch.argsort(perm)
        out[name] = dict(pos=final.lig_pos[back], traj=traj[:, back])
    return out


def step2d_case(inp: dict, mesh) -> dict:
    """One score-model step (dropout 0) with the state cut over a 2-D
    mesh's model axis; ``mesh`` None: one process."""
    model, cfg = _model(inp, dropout=0.0)
    state = train_loop.init_train_state(model, TrainConfig(lr=LR))
    if mesh is not None:
        state = meshlib.shard_model_tree(mesh, state)
    m = train_loop.make_train_step(cfg, TrainConfig(lr=LR), mesh)(state, batch_of(inp["batch"], inp.get("device", "cpu")),
                                                                    _gen(inp, 7))
    return dict(metrics={k: float(v) for k, v in m.items()}, n_cut=len(state.shards),
                params=_cpu(dict(state.model.named_parameters())), buffers=_cpu(dict(state.model.named_buffers())))


def cli_case(inp: dict, mesh) -> dict:
    """``inp["cli"]``'s ``main`` on ``inp["argv"]`` (with the rank's own
    ``inp["rank_argv"][rank]`` appended); for the training CLIs also each
    step's gradients and the parameters it left (``captured_gradients``),
    for finetune the buffer's items."""
    import importlib

    from confidence_bootstrapping_tpu_torch.bootstrapping import finetune as ft

    rank = dist.get_rank() if dist.is_initialized() else 0
    argv = list(inp["argv"]) + list(inp.get("rank_argv", [[]] * (rank + 1))[rank])
    buffers = []
    real = ft.CBBuffer

    def keep(**kw):
        buffers.append(real(**kw))
        return buffers[-1]

    ft.CBBuffer = keep
    grads, steps = [], []
    try:
        with captured_gradients(grads, steps):
            result = importlib.import_module(f"confidence_bootstrapping_tpu_torch.cli.{inp['cli']}").main(argv)
    finally:
        ft.CBBuffer = real
    if inp["cli"] == "infer":
        return dict(metrics=result)
    state, history = result
    items = [(b.name, float(b.confidence), b.iteration, np.asarray(b.padded["lig_pos"])) for b in
             (buffers[0].complexes if buffers else [])]
    return dict(history=history, buffer=items, grads=grads, steps=steps,
                params={n: p.detach().clone() for n, p in state.model.named_parameters()})


def api_case(inp: dict, mesh) -> dict:
    """The mesh API over the ranks of a 1-D mesh."""
    batch = batch_of(inp["batch"])
    mine = meshlib.shard_batch(mesh, batch)
    lin = torch.nn.Linear(3, 2)
    if mesh.rank:
        torch.nn.init.zeros_(lin.weight)
    meshlib.replicate(mesh, lin)
    try:
        meshlib.shard_batch(mesh, {"x": torch.zeros(3, 2)})
        uneven_refused = False
    except ValueError:
        uneven_refused = True
    return dict(shape=mesh.shape, index=mesh.index("data"), slice=mine.lig_pos,
                gathered=meshlib.gather_batch(mesh, mine).lig_pos,
                replicated=meshlib.replicate(mesh, {"x": torch.full((3,), float(mesh.rank))})["x"],
                module_equal=bool(meshlib.gather_batch(mesh, lin.weight[None]).std(0).abs().max() == 0),
                uneven_refused=uneven_refused)


def dp_case(inp: dict, mesh) -> dict:
    return dict(api=api_case(inp, mesh), train=train_case(inp, mesh), sample=sample_case(inp, mesh))


def env_case(inp: dict, mesh) -> dict:
    """The world the environment's contract started, and a sum over it."""
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    return dict(world=dist.get_world_size(), rank=dist.get_rank(), backend=dist.get_backend(), total=float(x))


JOBS = dict(dp=(dp_case, "1d"), train=(train_case, "1d"), step2d=(step2d_case, "2d"),
            cli=(cli_case, None), env=(env_case, None))


def run_ranks(job: str, d, world: int, inputs: dict, timeout: float = 240.0, env=None) -> list:
    """Run JOB in ``world`` rank processes on ``inputs`` and the tables the
    port serves now on ``inputs["device"]`` (default the CPU; ``env(rank)``:
    more environment for a rank); -> each rank's output. Fails with a rank's output when
    one exits non-zero or the ranks outlast ``timeout`` seconds (then every
    rank is killed)."""
    d = str(d)
    os.makedirs(d, exist_ok=True)
    torch.save(tables_of_the_port(inputs.get("device", "cpu")), os.path.join(d, "tables.pt"))
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen([sys.executable, os.path.abspath(__file__), job, d, str(r), str(world)],
                                       env={**base, **(env(r) if env else {})}, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {job} exited {p.returncode}:\n" +
                                 open(os.path.join(d, f"log{r}.txt")).read()[-6000:])
    return [torch.load(os.path.join(d, f"out{r}.pt"), weights_only=False) for r in range(world)]


def main(argv) -> None:
    job, d, rank, world = argv[0], argv[1], int(argv[2]), int(argv[3])
    torch.set_num_threads(1)
    if job == "env":  # the contract under test starts the group
        assert meshlib.maybe_init_distributed(device="cpu")
    else:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(d, 'store')}", world_size=world, rank=rank)
    serve_tables(torch.load(os.path.join(d, "tables.pt")))
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    fn, kind = JOBS[job]
    device = inp.get("device", "cpu")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    mesh = {"1d": lambda: meshlib.make_mesh(device=device),
            "2d": lambda: meshlib.make_mesh_2d(*inp["mesh2d"], device=device),
            None: lambda: None}[kind]()
    out = fn(inp, mesh)
    torch.save(out, os.path.join(d, f"out{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
