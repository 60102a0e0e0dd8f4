"""Per-layer cost model, the bottom layer of the energy accounting (a copy
of the JAX package's ``core/cost.py``: the CIFAR ResNet, MobileNetV2 and
transformer tables).

* :class:`LayerCost` — one layer's forward MACs / parameters / activation
  elements, plus whether SLU can gate it (identity-shortcut residual blocks
  only, as in ``models/resnet.py``).
* :class:`TableCostModel` — an immutable table of layers with the derived
  totals every consumer needs (``fwd_macs``, ``param_count``,
  ``train_macs``, gated fractions, moved words).
* :func:`resnet_cost` and :func:`mobilenet_cost` make the tables of the
  paper's CIFAR backbones (:func:`cnn_cost` dispatches on the model's
  name), :func:`lm_cost` the transformer stack's.

``MBV2_CFG`` and :func:`mbv2_layout` are MobileNetV2's block schedule, the
one copy the port keeps: ``models/resnet.MobileNetV2`` builds from it.

The tables are pinned against the JAX package's in the tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core import energy
from repro_torch.core.config import ModelConfig

# MobileNetV2 inverted-residual schedule, CIFAR variant: (expansion, cout,
# blocks, stride)
MBV2_CFG = [
    (1, 16, 1, 1), (6, 24, 2, 1), (6, 32, 3, 2),
    (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
MBV2_STEM, MBV2_HEAD = 32, 1280     # stem and head widths


def mbv2_layout() -> List[Tuple[int, int, int, int, bool]]:
    """Static per-block ``(cin, hidden, cout, stride, residual)`` from
    ``MBV2_CFG``: architecture facts that stay off the parameters."""
    cin, out = MBV2_STEM, []
    for t, c, nblk, s in MBV2_CFG:
        for b in range(nblk):
            stride = s if b == 0 else 1
            out.append((cin, cin * t, c, stride, stride == 1 and cin == c))
            cin = c
    return out


@dataclass(frozen=True)
class LayerCost:
    """Forward cost of one layer for one example (one image / one sequence).

    ``macs``       multiply-accumulates of the forward pass;
    ``params``     trainable parameters (bias/affine included);
    ``out_elems``  activation elements written (drives movement energy);
    ``gated``      True when the layer lives inside an SLU-gatable block
                   (identity-shortcut residual blocks; the paper never gates
                   projection-shortcut transitions — ``models/resnet.py``).
    """

    name: str
    kind: str            # conv | bn | fc | embed | block | head | dw
    macs: float
    params: int
    out_elems: float
    gated: bool = False


@dataclass(frozen=True)
class TableCostModel:
    """A resolved per-layer cost table with the derived totals."""

    name: str
    layers: Tuple[LayerCost, ...]

    # ----- totals -----
    def fwd_macs(self) -> float:
        """Forward MACs per example."""
        return sum(l.macs for l in self.layers)

    def param_count(self) -> int:
        return sum(l.params for l in self.layers)

    def act_elems(self) -> float:
        """Activation elements written per example per forward."""
        return sum(l.out_elems for l in self.layers)

    # ----- SLU structure -----
    def gated_macs(self) -> float:
        return sum(l.macs for l in self.layers if l.gated)

    def gated_fraction(self) -> float:
        """Fraction of forward MACs that SLU gates can skip."""
        total = self.fwd_macs()
        return self.gated_macs() / total if total else 0.0

    def gated_act_elems(self) -> float:
        return sum(l.out_elems for l in self.layers if l.gated)

    # ----- training-step costs -----
    def train_macs(self, batch: int, slu_exec: float = 1.0) -> float:
        """MACs of one training step: fwd + bwd-x + bwd-w ≈ 3 × fwd.

        ``slu_exec``: fraction of gated-block compute that executed (1.0 =
        no skipping).  Skipped blocks cost neither forward nor backward.
        """
        per_ex = self.fwd_macs() - (1.0 - slu_exec) * self.gated_macs()
        return 3.0 * batch * per_ex

    def moved_words(self, batch: int, slu_exec: float = 1.0) -> float:
        """Words streamed through SRAM per training step: parameters plus
        the executed activations, each touched ~once per pass (×3 passes) —
        the same movement model ``core/energy.training_energy_pj`` uses."""
        acts = self.act_elems() - (1.0 - slu_exec) * self.gated_act_elems()
        return 3.0 * (self.param_count() + batch * acts)


# ---------------------------------------------------------------------------
# CIFAR ResNet (6n+2) — mirrors models/resnet.py layer by layer
# ---------------------------------------------------------------------------


def _conv(name: str, hw: int, k: int, cin: int, cout: int,
          gated: bool = False) -> LayerCost:
    return LayerCost(name, "conv", float(hw * hw * k * k * cin * cout),
                     k * k * cin * cout, float(hw * hw * cout), gated)


def _bn(name: str, hw: int, c: int, gated: bool = False) -> LayerCost:
    # one multiply-add per element (scale + shift); affine params only —
    # running stats are non-trainable state, not parameters
    return LayerCost(name, "bn", float(hw * hw * c), 2 * c,
                     float(hw * hw * c), gated)


def resnet_cost(cfg: ModelConfig, image: int = 32) -> TableCostModel:
    """Per-layer cost of the CIFAR ResNet encoded by a ``family="cnn"``
    config (``num_layers`` = depth 6n+2, ``d_model`` = stage-0 width,
    ``vocab_size`` = classes) — ``configs/paper_cnns.cnn_model``."""
    depth, width, classes = cfg.num_layers, cfg.d_model, cfg.vocab_size
    assert (depth - 2) % 6 == 0, "CIFAR ResNet depth must be 6n+2"
    n = (depth - 2) // 6
    layers: List[LayerCost] = [
        _conv("stem", image, 3, 3, width), _bn("stem_bn", image, width)]
    hw, cin = image, width
    for stage, cout in enumerate((width, 2 * width, 4 * width)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            hw_in, hw = hw, hw // stride
            # identity-shortcut blocks gate; the projection transition
            # (channel change, owns `down`) never does — models/resnet.py
            gated = not (b == 0 and cin != cout)
            tag = f"s{stage}b{b}"
            layers += [
                _conv(f"{tag}.conv1", hw, 3, cin, cout, gated),
                _bn(f"{tag}.bn1", hw, cout, gated),
                _conv(f"{tag}.conv2", hw, 3, cout, cout, gated),
                _bn(f"{tag}.bn2", hw, cout, gated)]
            if b == 0 and cin != cout:
                layers.append(_conv(f"{tag}.down", hw, 1, cin, cout))
            cin = cout
    layers.append(LayerCost("fc", "fc", float(4 * width * classes),
                            4 * width * classes + classes, float(classes)))
    return TableCostModel(cfg.name, tuple(layers))


def mobilenet_cost(cfg: ModelConfig, image: int = 32) -> TableCostModel:
    """Per-layer cost of the CIFAR MobileNetV2 (``models/resnet.py``'s
    variant: stride-1 stem at 32², inverted residuals per ``MBV2_CFG``,
    1280-d head)."""
    classes = cfg.vocab_size
    layers: List[LayerCost] = [
        _conv("stem", image, 3, 3, MBV2_STEM),
        _bn("stem_bn", image, MBV2_STEM)]
    hw = image
    for i, (cin, hidden, cout, stride, _) in enumerate(mbv2_layout()):
        hw_out = hw // stride
        layers += [
            _conv(f"b{i}.expand", hw, 1, cin, hidden),
            _bn(f"b{i}.bn1", hw, hidden),
            # 3x3 depthwise: 9 MACs per output element per channel
            LayerCost(f"b{i}.dw", "dw", float(hw_out * hw_out * 9 * hidden),
                      9 * hidden, float(hw_out * hw_out * hidden)),
            _bn(f"b{i}.bn2", hw_out, hidden),
            _conv(f"b{i}.project", hw_out, 1, hidden, cout),
            _bn(f"b{i}.bn3", hw_out, cout)]
        hw = hw_out
    last = mbv2_layout()[-1][2]
    layers += [_conv("head", hw, 1, last, MBV2_HEAD),
               _bn("head_bn", hw, MBV2_HEAD),
               LayerCost("fc", "fc", float(MBV2_HEAD * classes),
                         MBV2_HEAD * classes + classes, float(classes))]
    return TableCostModel(cfg.name, tuple(layers))


def cnn_cost(cfg: ModelConfig, image: int = 32) -> TableCostModel:
    """Dispatch on the ``family="cnn"`` encoding's model name."""
    if cfg.family != "cnn":
        raise ValueError(f"cnn_cost: {cfg.name!r} has family={cfg.family!r}")
    if cfg.name == "mobilenetv2":
        return mobilenet_cost(cfg, image)
    return resnet_cost(cfg, image)


# ---------------------------------------------------------------------------
# Transformer LM — wraps the analytic model in core/energy.py
# ---------------------------------------------------------------------------


def lm_cost(cfg: ModelConfig, seq_len: int) -> TableCostModel:
    """Per-block cost table for the transformer stack at ``seq_len``.

    MACs = analytic FLOPs / 2 (``core/energy.block_fwd_flops``), per batch
    element.  Every block is SLU-gatable; embedding and head are not.
    """
    if cfg.family == "cnn":
        raise ValueError("lm_cost cannot price a CNN config; use cnn_cost")
    d = cfg.d_model
    layers: List[LayerCost] = [
        LayerCost("embed", "embed", 0.0, cfg.padded_vocab * d,
                  float(seq_len * d))]
    for i, kind in enumerate(cfg.blocks):
        layers.append(LayerCost(
            f"block{i}.{kind}", "block",
            energy.block_fwd_flops(cfg, kind, seq_len) / 2.0,
            cfg._block_params(kind, d, cfg.resolved_head_dim),
            float(seq_len * d), gated=True))
    head_params = 0 if cfg.tie_embeddings else cfg.padded_vocab * d
    layers.append(LayerCost(
        "head", "head", seq_len * d * cfg.vocab_size, head_params + d,
        float(seq_len * cfg.vocab_size)))
    return TableCostModel(cfg.name, tuple(layers))
