"""The system under test: the entries of the port (``repro_torch``) that
the loops run, and nothing else of it. The port is imported inside these
functions, so importing the harness loads no program code.
"""
from __future__ import annotations


def topology(topo: dict):
    """The port's ``CNNTopology`` of a configuration's ``topology``."""
    from repro_torch.models.cnn import CNNTopology, ConvLayerSpec

    return CNNTopology(
        name=topo["name"],
        input_hw=topo["input_hw"],
        input_channels=topo["input_channels"],
        conv_layers=tuple(ConvLayerSpec(**layer) for layer in topo["conv_layers"]),
        fc_dims=tuple(topo["fc_dims"]),
        n_classes=topo["n_classes"],
    )


def compile_plan(cfg: dict, params: dict, device):
    """``compile_dhm`` of the configuration at its inference quant mode:
    the plan whose ``__call__`` the inference window drives."""
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm

    return compile_dhm(topology(cfg["topology"]), params,
                       quant=QuantSpec(**cfg["infer_quant"]), device=device)


def train_step(cfg: dict, mix: dict):
    """``(step_fn, adamw_init)``: ``paper/train_cnn.py`` ``jit_train_step`` at
    ``train_cnn``'s settings and the configuration's QAT widths, and the
    optimizer state's constructor."""
    from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine
    from repro_torch.paper.train_cnn import jit_train_step

    opt = AdamWConfig(weight_decay=mix["weight_decay"])
    sched = linear_warmup_cosine(mix["peak_lr"], warmup_steps=mix["warmup_steps"],
                                 total_steps=mix["total_steps"])
    step_fn = jit_train_step(topology(cfg["topology"]), opt, sched, **cfg["train_quant"])
    return step_fn, (lambda params: adamw_init(params, opt))
