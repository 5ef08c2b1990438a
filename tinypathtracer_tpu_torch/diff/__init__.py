"""Differentiable / inverse rendering (port of `tinypathtracer_tpu/diff`)."""

from tinypathtracer_tpu_torch.diff.invrender import (AdamState, Optimizer,
                                                     Params, SgdState, adam,
                                                     adam_state_from_optax,
                                                     adam_step,
                                                     apply_params,
                                                     make_sharded_train_step,
                                                     make_train_step,
                                                     mse_loss,
                                                     project_physical,
                                                     render_mean, sgd,
                                                     sgd_state_from_optax)

__all__ = ["AdamState", "Optimizer", "Params", "SgdState", "adam",
           "adam_state_from_optax", "adam_step", "apply_params",
           "make_sharded_train_step", "make_train_step", "mse_loss",
           "project_physical", "render_mean", "sgd", "sgd_state_from_optax"]
