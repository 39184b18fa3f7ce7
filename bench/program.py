"""The system under test, ``repro_torch``, as the bench drives it: its
model built from the bench's weights, its train step and its eval step.
This module and ``bench/faults.py`` are the only ones that import it.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (
    TrainConfig, make_eval_step, make_train_step,
)

_FIELDS = {f.name for f in dataclasses.fields(ModelConfig)}


def model_config(config: dict, interpret: bool) -> ModelConfig:
    """The program's configuration of ``config`` (a configuration file);
    ``interpret`` runs the kernels' plain versions (CPU tests)."""
    m = {k: v for k, v in config["model"].items() if k in _FIELDS}
    return ModelConfig(arch_id=config["arch"], family=config["family"],
                       pallas_interpret=interpret, **m)


def build_model(mcfg: ModelConfig, weights: dict):
    """The program's model holding ``weights`` (the tensors themselves),
    after checking that they name and shape every parameter it has."""
    model = T.init_params(mcfg, device="meta")
    want = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    have = {n: (tuple(t.shape), t.dtype) for n, t in weights.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise ValueError(f"the bench's weights do not fit the program's "
                         f"model: {diff}")
    model.load_state_dict(weights, strict=True, assign=True)
    return model


def train_config(traffic: dict) -> TrainConfig:
    return TrainConfig(optimizer=opt.OptimizerConfig(**traffic["optimizer"]),
                       microbatches=traffic["microbatches"],
                       z_loss_coef=traffic["z_loss_coef"])


def train_step(mcfg: ModelConfig, traffic: dict):
    return make_train_step(mcfg, train_config(traffic))


def optimizer_state(model) -> dict:
    return opt.init_state(model)


def eval_step(mcfg: ModelConfig, traffic: dict):
    return make_eval_step(mcfg, TrainConfig(
        z_loss_coef=traffic["z_loss_coef"]))


def first_grad_norms(state: dict, b1: float) -> dict:
    """Each leaf's gradient as the optimizer took it on its first step,
    read from the first moment it left: m = (1 - b1) · g."""
    names = list(state["m"])
    norms = torch._foreach_norm([state["m"][n] for n in names], 2)
    return {n: float(x) / (1 - b1) for n, x in zip(names, norms)}
