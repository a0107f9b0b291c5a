"""The training orchestrator, single device.

Counterpart of ``pcgnn_tpu/train/trainer.py``.  Per epoch:
  1. *pick* a label-balanced sample of 2·|train_pos| training nodes,
  2. shuffle, split into fixed-size batches (the last padded with id 0 at
     weight 0),
  3. per batch: loss -> backward -> Adam with L2 weight decay added to the
     gradient before the moments (``torch.optim.Adam(weight_decay=...)``,
     the semantics of the JAX package's ``torch_adam``).
Validation every ``valid_epochs`` with the relative-gain model selection
rule, patience early stop and a restore-best final test.

The trainer runs on ``cuda`` unless the caller passes ``device="cpu"``; it
raises when CUDA is asked for and absent.  Random streams come from
``torch.Generator``s seeded from the config's seed and the epoch.
"""

from __future__ import annotations

import dataclasses
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
from pcgnn_tpu_torch.sampling.pick import pick_probs, pick_step
from pcgnn_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from pcgnn_tpu_torch.train.metrics import evaluate
from pcgnn_tpu_torch.train.results import ResultManager

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


def _reject_unported(cfg: dict) -> None:
    unported = [
        (cfg.get("distributed") or int(cfg.get("num_devices") or 1) > 1,
         "multi-device training (ROADMAP module 13)"),
        (cfg.get("learn_features"),
         "learn_features (ROADMAP module 10)"),
        (not cfg.get("edge_windows", True),
         "edge_windows: false, the lanes without edge-window stores "
         "(ROADMAP modules 4 and 8)"),
        (cfg.get("resume"), "resume (ROADMAP module 5, trainer remainder)"),
        (cfg.get("profile_dir"), "profile_dir (ROADMAP module 12)"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"config asks for {what}, which is "
                                      f"not ported yet")


def make_optimizer(model: torch.nn.Module, lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)


def train_step(model, optimizer, graph: MultiRelGraph, batch: torch.Tensor,
               y: torch.Tensor, w: torch.Tensor, consts: dict) -> torch.Tensor:
    """One optimizer step (loss -> gradients -> Adam); returns the loss."""
    optimizer.zero_grad(set_to_none=True)
    loss = model.loss(graph, batch, y, w, train_pos=consts["tp"],
                      train_pos_valid=consts["tpv"],
                      train_pos_feats=consts["tpf"])
    loss.backward()
    optimizer.step()
    return loss.detach()


class Trainer:
    def __init__(self, config: dict, graph: Optional[MultiRelGraph] = None,
                 result: Optional[ResultManager] = None, device=None):
        self.config = dict(config)
        cfg = self.config
        _reject_unported(cfg)
        self.device = resolve_device(device)
        self.result = result if result is not None else ResultManager(cfg)
        np.random.seed(cfg["seed"])

        if graph is None:
            thr = cfg.get("thresholds") or cfg.get("threshold", 0.5)
            graph = load_data(cfg["data_name"], cfg.get("data_prefix", "data/"),
                              threshold=thr, graph_id=cfg.get("graph_id"),
                              seed=cfg["seed"], device=self.device)
        else:
            graph = graph.to(self.device)
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
                graph, features=torch.as_tensor(feats, device=self.device))
        # the stores snapshot the features: built after any transform
        if graph.fused is None and all(r.ewin is None
                                       for r in graph.relations):
            graph = materialize_edge_windows(
                graph, dtype=_EWIN_DTYPES[cfg.get("ewin_dtype", "bfloat16")])
        self.graph = graph
        self.idx_train, self.idx_valid, self.idx_test = (idx_train, idx_valid,
                                                         idx_test)
        self.y_train = y_train
        self.y_valid, self.y_test = labels[idx_valid], labels[idx_test]
        self.train_pos, self.train_neg = train_pos, train_neg
        self.model_name = cfg["model"].upper()
        self.model = self.new_model()

        b = int(cfg["batch_size"])
        self.sample_size = max(2 * len(train_pos), 1)
        self.num_batches = max(-(-self.sample_size // b), 1)
        self.batch_size = b

        dev = self.device
        self.idx_train_dev = torch.as_tensor(idx_train, device=dev)
        self.pick_weights = pick_probs(
            graph.homo.deg[self.idx_train_dev],
            torch.as_tensor(y_train, device=dev))
        tp = train_pos if len(train_pos) else np.zeros(1, np.int64)
        self.train_pos_dev = torch.as_tensor(tp, device=dev)
        self.train_pos_valid = torch.full((len(tp),), bool(len(train_pos)),
                                          device=dev)
        # features[train_pos] is constant for the run (frozen features,
        # fixed split)
        self.consts = {"tp": self.train_pos_dev, "tpv": self.train_pos_valid,
                       "tpf": graph.features[self.train_pos_dev]}

    def new_model(self):
        """A freshly initialized model, from the config's seed."""
        cfg = self.config
        return build_model(
            self.model_name, feat_dim=self.graph.feat_dim,
            emb_dim=cfg["emb_size"], num_relations=self.graph.num_relations,
            alpha=cfg.get("alpha", 2.0), rho=cfg.get("rho", 0.5),
            generator=torch.Generator().manual_seed(int(cfg["seed"]))
        ).to(self.device)

    def new_optimizer(self, model) -> torch.optim.Adam:
        return make_optimizer(model, self.config["lr"],
                              self.config["weight_decay"])

    def epoch_plan(self, epoch: int):
        """(batches [nb, B] int64, weights [nb, B] float32) of one epoch:
        pick, shuffle, pad with id 0 at weight 0."""
        b, nb, s = self.batch_size, self.num_batches, self.sample_size
        g = torch.Generator(device=self.device)
        g.manual_seed(int(self.config["seed"]) * 1_000_003 + epoch)
        sampled = pick_step(g, self.idx_train_dev, self.pick_weights, s)
        sampled = sampled[torch.randperm(s, generator=g, device=self.device)]
        ids = torch.zeros(nb * b, dtype=torch.int64, device=self.device)
        ids[:s] = sampled
        w = torch.zeros(nb * b, dtype=torch.float32, device=self.device)
        w[:s] = 1.0
        return ids.view(nb, b), w.view(nb, b)

    def step(self, model, optimizer, batch, y, w) -> torch.Tensor:
        return train_step(model, optimizer, self.graph, batch, y, w,
                          self.consts)

    def run_epoch(self, model, optimizer, epoch: int) -> torch.Tensor:
        """One epoch of steps; returns the mean loss (on the device)."""
        batches, weights = self.epoch_plan(epoch)
        losses = [self.step(model, optimizer, bt, self.graph.labels[bt], wt)
                  for bt, wt in zip(batches, weights)]
        return torch.stack(losses).mean()

    def predict(self, model, batch: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            probs, _ = model.to_prob(self.graph, batch.to(self.device))
        return probs

    def train(self):
        cfg = self.config
        model = self.new_model()
        optimizer = self.new_optimizer(model)
        auc_best, f1_mac_best, epoch_best = 1e-10, 1e-10, 0
        select_f1 = cfg.get("select", "gain") == "f1"
        thresh_best = None
        best_state = {k: v.clone() for k, v in model.state_dict().items()}
        epoch_times = []
        for epoch in range(cfg["epochs"]):
            t0 = time.time()
            loss = float(self.run_epoch(model, optimizer, epoch))
            epoch_times.append(time.time() - t0)
            if (epoch + 1) % cfg["valid_epochs"] == 0:
                print(f"Valid at epoch {epoch} (loss {loss:.4f}, "
                      f"epoch_time {epoch_times[-1]*1e3:.1f}ms)")
                res = evaluate(lambda nodes: self.predict(model, nodes),
                               self.idx_valid, self.y_valid, self.batch_size,
                               result=self.result, epoch=epoch,
                               epoch_best=epoch_best, flag="val",
                               sweep_thresh=select_f1)
                gain_auc = (res.auc - auc_best) / auc_best
                gain_f1 = (res.f1_macro - f1_mac_best) / f1_mac_best
                if gain_auc + gain_f1 > 0:
                    auc_best, f1_mac_best, epoch_best = (res.auc, res.f1_macro,
                                                         epoch)
                    thresh_best = res.thresh
                    best_state = {k: v.clone()
                                  for k, v in model.state_dict().items()}
                    save_checkpoint(self.result.model_path,
                                    params_to_jax(model))
            if (epoch - epoch_best) > cfg["patience"]:
                print(f"Early stopping at epoch {epoch}")
                break

        print(f"Restore model from epoch {epoch_best}")
        try:
            best_state = params_from_jax(
                load_checkpoint(self.result.model_path))
        except FileNotFoundError:
            pass  # no validation improvement was ever recorded
        model.load_state_dict(best_state)
        res = evaluate(lambda nodes: self.predict(model, nodes),
                       self.idx_test, self.y_test, self.batch_size,
                       result=self.result, epoch_best=epoch_best, flag="test",
                       valid_thresh=thresh_best if select_f1 else None)
        self.result.save_predictions(res.anomaly_confidence,
                                     "anomaly_confidence")
        self.model = model
        self.epoch_times = epoch_times
        self.valid_thresh = thresh_best
        return res.auc, res.recall, res.f1_macro
