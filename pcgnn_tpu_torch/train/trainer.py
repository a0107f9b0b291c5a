"""The training orchestrator, on one device or sharded over ranks.

Counterpart of ``pcgnn_tpu/train/trainer.py``.  Per epoch:
  1. PC-GNN: *pick* a label-balanced sample of 2·|train_pos| training nodes;
     GCN and GraphSAGE: every training node once,
  2. shuffle, split into fixed-size batches (the last padded with id 0 at
     weight 0),
  3. per batch: loss -> backward -> Adam with L2 weight decay added to the
     gradient before the moments (``torch.optim.Adam(weight_decay=...)``,
     the semantics of the JAX package's ``torch_adam``).
Validation every ``valid_epochs`` with the relative-gain model selection
rule, patience early stop and a restore-best final test.  ``resume`` saves
the run's state at each validation and continues a cut run from it;
``profile_dir`` traces three epochs with ``torch.profiler``.

The trainer runs on ``cuda`` unless the caller passes ``device="cpu"``; it
raises when CUDA is asked for and absent.  Random streams come from
``torch.Generator``s seeded from the config's seed and the epoch.

Epochs (``run_epoch``, ``epoch_block``, ``train``) and ``single_step`` run
through ``train.capture.StepRunner``, the counterpart of the JAX Trainer's
jitted epoch: on CUDA every step is a replay of one captured CUDA graph
(forward, backward, Adam) -- sharded, of its pieces cut at the mesh's
collectives, with the collectives run between them -- with the hub lane's
chunks planned once an epoch; on the CPU, or with ``Trainer(...,
capture=False)``, the same steps run eagerly (``train_step``, sharded
``parallel.spmd.spmd_train_step``).  ``step`` is always the eager step,
with the hub lane planned from its own batch.  Evaluations (``evaluate``:
``train``'s validations and final test,
``eval_tools.threshold_transfer_eval``, ``quality_run``) run through
``train.capture.PredictRunner``, the counterpart of the JAX Trainer's
``predict_jit`` (sharded, its ``spmd_predict``): on CUDA every batch is a
replay of one captured forward (or its pieces), with the hub lane planned
once a node set, and the probabilities are read back once; on the CPU the
same forwards run eagerly.  ``predict`` is the eager forward of one
batch.

Sharded training (``parallel.spmd``): the process is one rank of a
``torch.distributed`` group and trains over a mesh of ranks.
``distributed: true`` joins the group named by ``coordinator_address``,
``num_processes`` and ``process_id`` (or ``PCGNN_PROCESS_ID``; without an
address, the ``env://`` variables) and arranges it as the
('dcn', 'data', 'graph') mesh (``mesh_graph``, ``mesh_data`` per host of
``ranks_per_host`` ranks); its device defaults to ``cuda:<local rank>``.
``num_devices: N > 1`` arranges an initialized group of N ranks as the
('data', 'graph') mesh (``mesh_graph``, else ``factor_mesh``); the CLI
starts those ranks (``cli.py``).  The backend is ``dist_backend`` or, by
default, nccl on CUDA and gloo on the CPU.  Every rank loads the graph on
the host and keeps only its shard on its device; every rank draws the same
epoch plans, and only rank 0 writes results and checkpoints.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from pcgnn_tpu_torch.data.loaders import NUM_UNLABELED, load_data
from pcgnn_tpu_torch.data.prep import (normalize_features, pos_neg_split,
                                       stratified_splits)
from pcgnn_tpu_torch.graph.csr import MultiRelGraph, materialize_edge_windows
from pcgnn_tpu_torch.interop import params_from_jax, params_to_jax
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.models.pcgnn import PCGNN
from pcgnn_tpu_torch.sampling.pick import pick_cdf, pick_probs, pick_step
from pcgnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pcgnn_tpu_torch.train.metrics import EvalResult, evaluate_probs
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.utils.profiling import section, span, trace

_EWIN_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``device`` or, by default, ``cuda``; raises when CUDA is asked for
    and no GPU is present (the port never falls back to the CPU on its
    own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device) but no GPU is "
            "available; pass device='cpu' to run the plain CPU path")
    return dev


def make_optimizer(model: torch.nn.Module, lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    """Adam over ``model``'s parameters; ``capturable`` on CUDA (its step
    count stays on the card, so a CUDA graph can hold the update), which
    the CPU refuses.  The eager and the captured step on the card share it,
    so the two give the same bits."""
    cuda = next(model.parameters()).is_cuda
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay,
                            capturable=cuda)


def adam_state(model: torch.nn.Module, optimizer: torch.optim.Adam) -> dict:
    """The optimizer's Adam state by parameter name, as numpy: ``step``,
    ``exp_avg`` and ``exp_avg_sq`` of each parameter that has taken a
    step."""
    return {name: {k: v.detach().cpu().numpy().copy()
                   for k, v in optimizer.state[p].items()}
            for name, p in model.named_parameters() if optimizer.state.get(p)}


def load_adam_state(model: torch.nn.Module, optimizer: torch.optim.Adam,
                    state: dict) -> None:
    """Restore ``adam_state``'s output into ``optimizer``, built over
    ``model.parameters()``.  An optimizer that has state already takes the
    values in place (``copy_``), so a captured step keeps reading the
    tensors it was captured with; a fresh one gets them through
    ``Optimizer.load_state_dict``, which places each tensor as torch's Adam
    keeps it: the moments on the parameter's device in its dtype, ``step``
    in the dtype saved (on the parameter's device when capturable)."""
    if optimizer.state:
        for name, p in model.named_parameters():
            if name in state:
                for k, v in state[name].items():
                    optimizer.state[p][k].copy_(torch.from_numpy(np.array(v)))
        return
    sd = optimizer.state_dict()
    sd["state"] = {i: {k: torch.from_numpy(np.array(v))
                       for k, v in state[name].items()}
                   for i, (name, _) in enumerate(model.named_parameters())
                   if name in state}
    optimizer.load_state_dict(sd)


def train_step(model, optimizer, graph: MultiRelGraph, batch: torch.Tensor,
               y: torch.Tensor, w: torch.Tensor, consts: dict,
               generator: Optional[torch.Generator] = None,
               hub_plans: Optional[tuple] = None) -> torch.Tensor:
    """One optimizer step (loss -> gradients -> Adam); returns the loss.
    PC-GNN's loss reads the train positives in ``consts``; GraphSAGE draws
    its ``num_sample`` subsets from ``generator``; ``hub_plans`` fixes the
    hub lane's chunks (None: planned from this batch).  This is the step
    that ``train.capture.StepRunner`` captures."""
    optimizer.zero_grad(set_to_none=True)
    if isinstance(model, PCGNN):
        loss = model.loss(graph, batch, y, w, train_pos=consts["tp"],
                          train_pos_valid=consts["tpv"],
                          train_pos_feats=consts.get("tpf"),
                          hub_plans=hub_plans)
    else:
        loss = model.loss(graph, batch, y, w, generator=generator,
                          hub_plans=hub_plans)
    section("backward")
    loss.backward()
    section("adam")
    optimizer.step()
    section(None)
    return loss.detach()


class Trainer:
    def __init__(self, config: dict, graph: Optional[MultiRelGraph] = None,
                 result: Optional[ResultManager] = None, device=None,
                 capture: Optional[bool] = None):
        """``capture``: run epochs and evaluations as replays of a
        captured CUDA graph (``train.capture``; sharded, its pieces cut at
        the collectives); by default on CUDA, never on the CPU."""
        self.config = dict(config)
        cfg = self.config
        self.learn_features = bool(cfg.get("learn_features"))
        self.distributed = bool(cfg.get("distributed"))
        self.num_devices = int(cfg.get("num_devices") or 1)
        sharded = self.distributed or self.num_devices > 1
        if self.learn_features and sharded:
            raise NotImplementedError(
                "learn_features trains the node table through the dense "
                "mask-GEMM lane, which is single-device only (the sharded "
                "lanes assume a frozen sharded table); drop num_devices/"
                "distributed or learn_features")
        self.device = resolve_device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError("capture=True needs a single CUDA device a "
                             "rank: the CPU runs eagerly")
        self.capture = capture
        self._runner = None
        self._predict_runner = None
        self.mesh = self._join_mesh(device) if sharded else None
        if self.mesh is not None and device is None and self.distributed:
            self.device = resolve_device(
                f"cuda:{self.mesh.rank % self._ranks_per_host()}")
        if (self.mesh is not None and self.device.type == "cuda"
                and self.device.index is not None):
            # a rank's collectives and kernels run on its own card
            torch.cuda.set_device(self.device)
        self.result = result if result is not None else ResultManager(cfg)
        np.random.seed(cfg["seed"])

        # sharded: the graph stays on the host, each rank's shard goes to
        # its device (parallel.spmd.shard_graph)
        graph_dev = "cpu" if sharded else self.device
        if graph is None:
            thr = cfg.get("thresholds") or cfg.get("threshold", 0.5)
            graph = load_data(cfg["data_name"], cfg.get("data_prefix", "data/"),
                              threshold=thr, graph_id=cfg.get("graph_id"),
                              seed=cfg["seed"], device=graph_dev)
        else:
            graph = graph.to(graph_dev)
        labels = graph.labels.cpu().numpy()

        idx_train, idx_valid, idx_test = stratified_splits(
            labels, cfg["train_ratio"], cfg["test_ratio"], cfg["seed"],
            num_unlabeled=NUM_UNLABELED.get(cfg["data_name"], 0))
        y_train = labels[idx_train]
        train_pos, train_neg = pos_neg_split(idx_train, y_train)

        if cfg["data_name"].startswith("amazon"):
            # amazon-family features are row-normalized
            feats = normalize_features(graph.features.cpu().numpy())
            graph = dataclasses.replace(
                graph, features=torch.as_tensor(feats, device=graph_dev),
                features_pad=None)
        # the stores snapshot the features: built after any transform, for
        # the model that reads them (PC-GNN the relations', GCN and
        # GraphSAGE the homo graph's).  The learned-feature lane reads the
        # trainable table itself, and edge_windows: false builds nothing
        self.model_name = cfg["model"].upper()
        self.is_pcgnn = self.model_name == "PCGNN"
        has_stores = graph.fused is not None or any(
            r.ewin is not None for r in (*graph.relations, graph.homo))
        if (cfg.get("edge_windows", True) and not self.learn_features
                and not has_stores and not sharded):
            graph = materialize_edge_windows(
                graph, dtype=_EWIN_DTYPES[cfg.get("ewin_dtype", "bfloat16")],
                relations=self.is_pcgnn, homo=not self.is_pcgnn,
                fused=self.is_pcgnn)
        self.graph = graph
        self.idx_train, self.idx_valid, self.idx_test = (idx_train, idx_valid,
                                                         idx_test)
        self.y_train = y_train
        self.y_valid, self.y_test = labels[idx_valid], labels[idx_test]
        self.train_pos, self.train_neg = train_pos, train_neg
        self.model = self.new_model()

        b = int(cfg["batch_size"])
        if self.mesh is not None and b % self.mesh.dd:
            # batches shard over the data axes; padded slots weigh 0
            b = -(-b // self.mesh.dd) * self.mesh.dd
            print(f"Rounded batch_size up to {b} (divisible by the data "
                  f"axes {self.mesh.dd})")
        self.sample_size = max(2 * len(train_pos) if self.is_pcgnn
                               else len(idx_train), 1)
        self.num_batches = max(-(-self.sample_size // b), 1)
        self.batch_size = b

        dev = self.device
        self.idx_train_dev = torch.as_tensor(idx_train, device=dev)
        self.labels = graph.labels.to(dev)
        self.pick_weights = pick_probs(
            graph.homo.deg.to(dev)[self.idx_train_dev],
            torch.as_tensor(y_train, device=dev))
        # the weights are fixed for the run: their CDF is summed once
        self.pick_cdf = pick_cdf(self.pick_weights)
        tp = train_pos if len(train_pos) else np.zeros(1, np.int64)
        self.train_pos_dev = torch.as_tensor(tp, device=dev)
        self.train_pos_valid = torch.full((len(tp),), bool(len(train_pos)),
                                          device=dev)
        self.consts = {"tp": self.train_pos_dev, "tpv": self.train_pos_valid}
        if not self.learn_features:
            # features[train_pos] is constant for the run (frozen features,
            # fixed split); the learned lane scores the current table
            self.consts["tpf"] = graph.features[tp].to(dev)
        self.sharded = None
        if self.mesh is not None:
            from pcgnn_tpu_torch.parallel.spmd import shard_graph
            m = self.mesh
            print(f"Sharded over the mesh {m.shape}: rank {m.rank}, data "
                  f"block {m.data_rank}, graph block {m.graph_index}, "
                  f"{m.backend} on {dev}")
            self.sharded = shard_graph(
                graph, self.mesh, pcgnn=self.is_pcgnn,
                edge_windows=bool(cfg.get("edge_windows", True)),
                ewin_dtype=_EWIN_DTYPES[cfg.get("ewin_dtype", "bfloat16")],
                device=dev)

    def _ranks_per_host(self) -> int:
        import torch.distributed as dist
        rph = self.config.get("ranks_per_host") or os.environ.get(
            "LOCAL_WORLD_SIZE")
        return int(rph) if rph else dist.get_world_size()

    def _join_mesh(self, device):
        """Join the process group (``distributed``) or take the one this
        process is a rank of (``num_devices``), and arrange it as the
        mesh."""
        import torch.distributed as dist

        from pcgnn_tpu_torch.parallel.distributed import (
            default_backend, ensure_initialized, make_multihost_mesh)
        from pcgnn_tpu_torch.parallel.mesh import factor_mesh, make_mesh
        cfg = self.config
        backend = cfg.get("dist_backend") or default_backend(self.device)
        if self.distributed:
            pid = cfg.get("process_id")
            if pid is None and os.environ.get("PCGNN_PROCESS_ID") is not None:
                pid = int(os.environ["PCGNN_PROCESS_ID"])
            ensure_initialized(cfg.get("coordinator_address"),
                               cfg.get("num_processes"), pid, backend=backend)
            return make_multihost_mesh(
                graph=int(cfg.get("mesh_graph") or 1),
                data=int(cfg["mesh_data"]) if cfg.get("mesh_data") else None,
                ranks_per_host=self._ranks_per_host())
        n = self.num_devices
        if self.device.type == "cuda" and n > torch.cuda.device_count():
            raise ValueError(f"num_devices={n} but only "
                             f"{torch.cuda.device_count()} devices are "
                             f"visible")
        if not dist.is_initialized() or dist.get_world_size() != n:
            raise RuntimeError(
                f"num_devices={n} runs one process per device: start the "
                f"ranks with pcgnn_tpu_torch.cli, or join a group of {n} "
                f"ranks (torch.distributed) before building the Trainer")
        dg = cfg.get("mesh_graph")
        dd, dg = (n // int(dg), int(dg)) if dg else factor_mesh(n)
        return make_mesh(data=dd, graph=dg)

    @property
    def is_main(self) -> bool:
        """Whether this process writes results and checkpoints: the only
        one, or rank 0 of the mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def new_model(self):
        """A freshly initialized model, from the config's seed; a learned
        node table starts from the graph's features (after any
        normalization)."""
        cfg = self.config
        gen = torch.Generator().manual_seed(int(cfg["seed"]))
        if not self.is_pcgnn:
            return build_model(self.model_name, feat_dim=self.graph.feat_dim,
                               emb_dim=cfg["emb_size"],
                               num_sample=cfg.get("num_sample"),
                               generator=gen).to(self.device)
        return build_model(
            self.model_name, feat_dim=self.graph.feat_dim,
            emb_dim=cfg["emb_size"], num_relations=self.graph.num_relations,
            alpha=cfg.get("alpha", 2.0), rho=cfg.get("rho", 0.5),
            learn_features=self.learn_features,
            features=self.graph.features if self.learn_features else None,
            generator=gen).to(self.device)

    def new_optimizer(self, model) -> torch.optim.Adam:
        return make_optimizer(model, self.config["lr"],
                              self.config["weight_decay"])

    def epoch_plan(self, epoch: int):
        """(batches [nb, B] int64, weights [nb, B] float32) of one epoch:
        pick (PC-GNN; the other models take every training node), shuffle,
        pad with id 0 at weight 0."""
        b, nb, s = self.batch_size, self.num_batches, self.sample_size
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.config["seed"]) * 1_000_003 + epoch)
        sampled = (pick_step(g, self.idx_train_dev, self.pick_cdf, s)
                   if self.is_pcgnn else self.idx_train_dev)
        sampled = sampled[torch.randperm(s, generator=g, device=self.device)]
        ids = torch.zeros(nb * b, dtype=torch.int64, device=self.device)
        ids[:s] = sampled
        w = torch.zeros(nb * b, dtype=torch.float32, device=self.device)
        w[:s] = 1.0
        return ids.view(nb, b), w.view(nb, b)

    def step_seed(self, epoch: int, step: int) -> int:
        """The seed of one step's random draws, from (seed, epoch, step)."""
        return ((int(self.config["seed"]) * 1_000_003 + epoch) * 1_000_003
                + step + 1)

    def step_generator(self, epoch: int, step: int):
        """A fresh generator for one step's random draws (GraphSAGE's
        ``num_sample``), seeded with ``step_seed``; None for models that
        draw nothing."""
        if getattr(self.model, "num_sample", None) is None:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(self.step_seed(epoch, step))
        return g

    def _planner(self):
        """The hub plan of a stack for the runners: None (the model's
        relations, ``ops.hub.epoch_hub_plans``) on one device, the sharded
        plan (``parallel.spmd.spmd_epoch_hub_plans``) over the mesh."""
        if self.sharded is None:
            return None
        from pcgnn_tpu_torch.parallel.spmd import spmd_epoch_hub_plans
        sg = self.sharded
        return lambda batches: spmd_epoch_hub_plans(sg, batches)

    def runner(self, model, optimizer):
        """The ``StepRunner`` of (model, optimizer): made at the first call
        for the pair, kept while the pair is the same (its captured graph
        holds their tensors), replaced for another pair.  Its step is
        ``train_step``, or ``spmd_train_step`` on a sharded trainer."""
        from pcgnn_tpu_torch.train.capture import StepRunner
        if self._runner is not None and self._runner[0] is model \
                and self._runner[1] is optimizer:
            return self._runner[2]
        graph, consts, sg = self.graph, self.consts, self.sharded

        def step_fn(batch, y, w, generator, hub_plans):
            if sg is not None:
                from pcgnn_tpu_torch.parallel.spmd import spmd_train_step
                return spmd_train_step(model, optimizer, sg, batch, y, w,
                                       consts, generator, hub_plans)
            return train_step(model, optimizer, graph, batch, y, w, consts,
                              generator, hub_plans)

        self._runner = None           # the old graph's pool goes first
        r = StepRunner(step_fn, model.hub_relations(graph), self.device,
                       capture=self.capture,
                       draws=getattr(model, "num_sample", None) is not None,
                       planner=self._planner())
        self._runner = (model, optimizer, r)
        return r

    def predict_runner(self, model):
        """The ``PredictRunner`` of ``model``: made at the first call for
        it, kept while the model holds the same tensors (its captured
        graph reads them), replaced for another model.  Its static
        buffers and its hub plan cover the validation and the test
        stacks, so one capture serves both."""
        from pcgnn_tpu_torch.train.capture import PredictRunner
        held = tuple(v.data_ptr() for v in model.state_dict().values())
        if self._predict_runner is not None \
                and self._predict_runner[0] is model \
                and self._predict_runner[1] == held:
            return self._predict_runner[2]
        graph, sg, consts = self.graph, self.sharded, self.consts
        draws = getattr(model, "num_sample", None) is not None

        def predict_fn(batch, generator, hub_plans):
            kw = {"generator": generator} if draws else {}
            if sg is not None:
                from pcgnn_tpu_torch.parallel.spmd import (spmd_homo_predict,
                                                           spmd_predict)
                if self.is_pcgnn:
                    return spmd_predict(model, sg, batch, consts["tp"],
                                        consts["tpv"], hub_plans=hub_plans)
                return spmd_homo_predict(model, sg, batch,
                                         hub_plans=hub_plans, **kw)
            with torch.no_grad():
                return model.to_prob(graph, batch, hub_plans=hub_plans,
                                     **kw)[0]

        stacks = [self._stack(nodes) for nodes in (self.idx_valid,
                                                   self.idx_test)]
        self._predict_runner = None   # the old graph's pool goes first
        r = PredictRunner(predict_fn, model.hub_relations(graph),
                          self.device, capture=self.capture, draws=draws,
                          rows=max(len(s) for s in stacks),
                          planner=self._planner())
        for stack in stacks:
            r.plan(stack)
        self._predict_runner = (model, held, r)
        return r

    def _stack(self, nodes) -> torch.Tensor:
        """``nodes`` padded with id 0 to [nb, B] on the device, as
        ``train.metrics.evaluate`` pads its batches."""
        nodes = np.asarray(nodes)
        b = self.batch_size
        ids = np.zeros((-(-len(nodes) // b), b), np.int64)
        ids.reshape(-1)[: len(nodes)] = nodes
        ids = torch.from_numpy(ids)
        if self.device.type == "cuda":
            ids = ids.pin_memory()    # so the copy makes no host sync
        return ids.to(self.device, non_blocking=True)

    def evaluate(self, model, nodes, labels, **kw) -> EvalResult:
        """``train.metrics.evaluate`` of ``model`` on ``nodes``, with the
        batches stacked (``_stack``): one forward a batch through
        ``predict_runner`` (on CUDA a replay of the captured forward;
        sharded, of its pieces, the full batch's probabilities on every
        rank), the [m, 2] probabilities read back once and handed to
        ``train.metrics.evaluate_probs`` with the keywords ``kw``.  The
        same probabilities, bit for bit, as ``evaluate`` over
        ``predict``."""
        with span("pcgnn.evaluate"):
            with span("pcgnn.evaluate.stack"):
                stack = self._stack(nodes)
            probs = self.predict_runner(model).run(stack)
            with span("pcgnn.evaluate.readback"):
                probs = probs.reshape(-1, 2)[: len(nodes)].cpu().numpy()
            with span("pcgnn.evaluate.metrics"):
                return evaluate_probs(probs, labels, **kw)

    def step(self, model, optimizer, batch, y, w,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One optimizer step on the full batch; sharded, each rank
        computes its block and every rank returns the same loss."""
        if self.sharded is not None:
            from pcgnn_tpu_torch.parallel.spmd import spmd_train_step
            return spmd_train_step(model, optimizer, self.sharded, batch, y,
                                   w, self.consts, generator)
        return train_step(model, optimizer, self.graph, batch, y, w,
                          self.consts, generator)

    def single_step(self, model, optimizer, batch, y, w, nscan: int = 1):
        """(fn, args) of the training step, the entry point
        ``utils.roofline.measure`` times: ``fn(*args)`` runs ``nscan``
        back-to-back optimizer steps, step i on ``batch``, ``y`` and ``w``
        rolled by i, as the JAX package's scan rolls them, and returns the
        last step's loss.  The steps are the epoch's (``runner``: replays
        of the captured step on CUDA, with one hub plan for the nscan
        batches; on a sharded trainer the sharded step, which the JAX
        package's single-device ``single_step`` does not take).  Every call
        steps ``model`` and ``optimizer`` on; divide a call's time by
        ``nscan``."""
        dev = self.device
        args = (model, optimizer, torch.as_tensor(batch, device=dev),
                torch.as_tensor(y, device=dev),
                torch.as_tensor(w, dtype=torch.float32, device=dev))
        seeds = [self.step_seed(0, i) for i in range(nscan)]

        def fn(model, optimizer, batch, y, w):
            rolled = [torch.stack([torch.roll(a, i) for i in range(nscan)])
                      for a in (batch, y, w)]
            return self.runner(model, optimizer).run(*rolled, seeds)[-1]

        return fn, args

    def run_epoch(self, model, optimizer, epoch: int) -> torch.Tensor:
        """One epoch of steps; returns the mean loss (on the device).  The
        epoch's steps go through ``runner``: one hub plan for the epoch
        (its only read-back), then a replay of the captured step per batch
        (or the eager step, on the CPU); sharded, the plan's one graph
        collective comes first and gloo's round trips run between a
        replay's pieces."""
        with span("pcgnn.epoch"):
            with span("pcgnn.epoch.pick"):
                batches, weights = self.epoch_plan(epoch)
                labels = self.labels[batches]
                seeds = [self.step_seed(epoch, i)
                         for i in range(self.num_batches)]
            return self.runner(model, optimizer).run(
                batches, labels, weights, seeds).mean()

    def epoch_block(self, model, optimizer, first_epoch: int,
                    num_epochs: int) -> torch.Tensor:
        """Epochs ``first_epoch .. first_epoch + num_epochs - 1`` back to
        back (``run_epoch``), with no read-back to the host; returns the
        last epoch's mean loss, on the device (0 for no epoch).  The
        counterpart of the JAX package's ``epoch_block_fn``."""
        loss = torch.zeros((), device=self.device)
        for epoch in range(first_epoch, first_epoch + num_epochs):
            loss = self.run_epoch(model, optimizer, epoch)
        return loss

    def predict(self, model, batch: torch.Tensor) -> torch.Tensor:
        """[B, 2] probabilities; sharded, the full batch on every rank."""
        batch = batch.to(self.device)
        if self.sharded is not None:
            from pcgnn_tpu_torch.parallel.spmd import (spmd_homo_predict,
                                                       spmd_predict)
            if self.is_pcgnn:
                return spmd_predict(model, self.sharded, batch,
                                    self.consts["tp"], self.consts["tpv"])
            return spmd_homo_predict(model, self.sharded, batch)
        with torch.no_grad():
            probs, _ = model.to_prob(self.graph, batch)
        return probs

    def _resume_path(self) -> str:
        """The resume file of this (model, data, seed, train ratio) in the
        result tree's ``saved_models``, under the JAX package's name.  It
        holds the port's own Adam state, so it resumes the port only: the
        JAX package cannot load it."""
        cfg = self.config
        tag = (f"resume-{cfg['model']}-{cfg['data_name'].replace(':', '_')}"
               f"-seed{cfg['seed']}-tr{cfg['train_ratio']}")
        return os.path.join(self.result.dirs["models"], f"{tag}.ckpt")

    def train(self):
        cfg = self.config
        model = self.new_model()
        optimizer = self.new_optimizer(model)
        auc_best, f1_mac_best, epoch_best = 1e-10, 1e-10, 0
        start_epoch = 0
        select_f1 = cfg.get("select", "gain") == "f1"
        thresh_best = None
        # mid-training resume: parameters, Adam state and selection state.
        # The epoch plans and GraphSAGE's draws are seeded from the epoch
        # and step, so a resumed run replays the uncut run's batches
        if cfg.get("resume"):
            try:
                st = load_checkpoint(self._resume_path())
            except FileNotFoundError:
                pass  # no resume file yet: start fresh
            else:
                model.load_state_dict(params_from_jax(st["params"]))
                load_adam_state(model, optimizer, st["opt_state"])
                auc_best, f1_mac_best = st["auc_best"], st["f1_mac_best"]
                epoch_best, start_epoch = st["epoch_best"], st["epoch"] + 1
                thresh_best = st.get("thresh_best")
                print(f"Resumed from epoch {st['epoch']}")
        best_state = {k: v.clone() for k, v in model.state_dict().items()}
        epoch_times, epoch_losses = [], []
        # sharded: every rank runs the same control flow (the metrics are
        # the same on every rank), but only rank 0 writes results,
        # checkpoints and the trace; the others keep the best state in
        # memory
        is_main = self.is_main
        result = self.result if is_main else None
        profile_dir = cfg.get("profile_dir") if is_main else None
        # the trace spans epochs start+2 to start+4, and closes when the
        # epochs end first
        with contextlib.ExitStack() as tracing:
            for epoch in range(start_epoch, cfg["epochs"]):
                if profile_dir and epoch == start_epoch + 2:
                    tracing.enter_context(trace(profile_dir, self.device))
                t0 = time.time()
                loss = float(self.run_epoch(model, optimizer, epoch))
                epoch_times.append(time.time() - t0)
                epoch_losses.append(loss)
                if profile_dir and epoch == start_epoch + 4:
                    tracing.close()
                if (epoch + 1) % cfg["valid_epochs"] == 0:
                    print(f"Valid at epoch {epoch} (loss {loss:.4f}, "
                          f"epoch_time {epoch_times[-1]*1e3:.1f}ms)")
                    res = self.evaluate(model, self.idx_valid, self.y_valid,
                                        result=result, epoch=epoch,
                                        epoch_best=epoch_best, flag="val",
                                        sweep_thresh=select_f1)
                    gain_auc = (res.auc - auc_best) / auc_best
                    gain_f1 = (res.f1_macro - f1_mac_best) / f1_mac_best
                    if gain_auc + gain_f1 > 0:
                        auc_best, f1_mac_best, epoch_best = (
                            res.auc, res.f1_macro, epoch)
                        thresh_best = res.thresh
                        best_state = {k: v.clone()
                                      for k, v in model.state_dict().items()}
                        if is_main:
                            save_checkpoint(self.result.model_path,
                                            params_to_jax(model))
                    if cfg.get("resume") and is_main:
                        save_checkpoint(self._resume_path(), dict(
                            params=params_to_jax(model),
                            opt_state=adam_state(model, optimizer),
                            epoch=epoch, auc_best=auc_best,
                            f1_mac_best=f1_mac_best, epoch_best=epoch_best,
                            thresh_best=thresh_best))
                if (epoch - epoch_best) > cfg["patience"]:
                    print(f"Early stopping at epoch {epoch}")
                    break

        print(f"Restore model from epoch {epoch_best}")
        if is_main:
            try:
                best_state = params_from_jax(
                    load_checkpoint(self.result.model_path))
            except FileNotFoundError:
                pass  # no validation improvement was ever recorded
        model.load_state_dict(best_state)
        res = self.evaluate(model, self.idx_test, self.y_test, result=result,
                            epoch_best=epoch_best, flag="test",
                            valid_thresh=thresh_best if select_f1 else None)
        if is_main:
            self.result.save_predictions(res.anomaly_confidence,
                                         "anomaly_confidence")
        self.model = model
        self.epoch_times = epoch_times
        self.epoch_losses = epoch_losses
        self.valid_thresh = thresh_best
        return res.auc, res.recall, res.f1_macro
