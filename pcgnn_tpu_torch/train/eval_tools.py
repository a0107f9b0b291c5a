"""Post-hoc evaluation: reload a saved parameter checkpoint, calibrate the
decision threshold on the validation split (``get_best_f1``), and re-test
with that threshold.

Counterpart of ``pcgnn_tpu/train/eval_tools.py``; the checkpoint is the
JAX parameter tree that both packages write (``interop``), and the model
runs on the trainer's device, through ``Trainer.evaluate`` (a model of its
own, so a runner of its own).
"""

from __future__ import annotations

from typing import Optional

from pcgnn_tpu_torch.interop import params_from_jax
from pcgnn_tpu_torch.train.checkpoint import load_checkpoint
from pcgnn_tpu_torch.train.metrics import get_best_f1
from pcgnn_tpu_torch.train.trainer import Trainer


def threshold_transfer_eval(trainer: Trainer,
                            checkpoint_path: Optional[str] = None):
    """Calibrate the anomaly threshold on validation, apply it to test.

    Returns (valid_result, test_result, threshold)."""
    if checkpoint_path is None:
        checkpoint_path = trainer.result.model_path
    model = trainer.new_model()
    model.load_state_dict(params_from_jax(load_checkpoint(checkpoint_path)))

    val_res = trainer.evaluate(model, trainer.idx_valid, trainer.y_valid,
                               print_line=False)
    _, thresh = get_best_f1(trainer.y_valid, val_res.anomaly_confidence)
    test_res = trainer.evaluate(model, trainer.idx_test, trainer.y_test,
                                print_line=False, valid_thresh=thresh)
    return val_res, test_res, thresh


def model_select(result_manager, metric: str = "auc") -> str:
    """Best checkpoint path for a (model, dataset) pair by test metric."""
    return result_manager.get_best_model_path(metric)
