"""The paper's own backbones: ResNet-74, ResNet-110 and MobileNetV2 on
CIFAR (§4.1), and the convolution geometries they run."""
from typing import List, NamedTuple, Optional, Tuple

from repro_torch.core.config import (E2TrainConfig, Experiment, ModelConfig,
                                     TrainConfig)
from repro_torch.core.cost import MBV2_HEAD, MBV2_STEM, mbv2_layout


def cnn_model(name: str, depth: int, num_classes: int = 10,
              width: int = 16) -> ModelConfig:
    """``num_layers`` is the CIFAR ResNet depth (6n+2), ``d_model`` the
    stage-0 width, ``vocab_size`` the class count.  A model named
    ``"mobilenetv2"`` selects the MobileNetV2 backbone, whose widths are
    its own (depth and width are ignored)."""
    return ModelConfig(name=name, family="cnn", num_layers=depth,
                       d_model=width, num_heads=1, num_kv_heads=1, d_ff=0,
                       vocab_size=num_classes, glu=False, dtype="float32")


def cnn_train(lr: float = 0.1) -> TrainConfig:
    """The paper's CIFAR training config: batch 128, 64k iterations, SGD
    with momentum."""
    return TrainConfig(global_batch=128, lr=lr, total_steps=64000,
                       optimizer="sgdm", weight_decay=1e-4)


def resnet74(num_classes: int = 10,
             e2: Optional[E2TrainConfig] = None) -> Experiment:
    return Experiment(model=cnn_model("resnet74", 74, num_classes),
                      e2=e2 or E2TrainConfig(), train=cnn_train(0.1),
                      task="cifar_cnn")


def resnet110(num_classes: int = 10,
              e2: Optional[E2TrainConfig] = None) -> Experiment:
    return Experiment(model=cnn_model("resnet110", 110, num_classes),
                      e2=e2 or E2TrainConfig(), train=cnn_train(0.1),
                      task="cifar_cnn")


def mobilenetv2(num_classes: int = 10,
                e2: Optional[E2TrainConfig] = None) -> Experiment:
    return Experiment(model=cnn_model("mobilenetv2", 0, num_classes),
                      e2=e2 or E2TrainConfig(), train=cnn_train(0.05),
                      task="cifar_cnn")


class ConvShape(NamedTuple):
    """One convolution site of a CIFAR backbone.  ``hw`` is the *input*
    extent; SAME padding ``k // 2`` is implied, so the output extent is
    ``ceil(hw / stride)``."""

    batch: int
    hw: int
    cin: int
    cout: int
    k: int
    stride: int

    @property
    def hw_out(self) -> int:
        return -(-self.hw // self.stride)

    @property
    def kind(self) -> str:
        """"body" (3x3 stride-1), "strided" (3x3 stride-2 transition),
        "down" (1x1 projection shortcut, stride 2), "point" (1x1)."""
        if self.k == 1:
            return "down" if self.stride > 1 else "point"
        return "strided" if self.stride > 1 else "body"

    @property
    def im2col(self) -> Tuple[int, int, int]:
        """``(N, din, dout)`` of the matmul this conv is on the im2col path:
        ``N = B*H'*W'``, ``din = k*k*Cin``, ``dout = Cout``."""
        return (self.batch * self.hw_out * self.hw_out,
                self.k * self.k * self.cin, self.cout)


def resnet_conv_shapes(depth: int = 74, width: int = 16, batch: int = 128,
                       image: int = 32, unique: bool = True
                       ) -> List[ConvShape]:
    """Convolution geometries of a CIFAR ResNet in network order: stem,
    then per stage the transition conv1 (stride 2 from stage 1 on), conv2,
    the 1x1 stride-2 projection shortcut, and the body convs.  With
    ``unique=False`` every conv site is returned, with multiplicity."""
    n = (depth - 2) // 6
    shapes: List[ConvShape] = [ConvShape(batch, image, 3, width, 3, 1)]
    H, cin = image, width
    for stage, cout in enumerate((width, 2 * width, 4 * width)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            shapes.append(ConvShape(batch, H, cin if b == 0 else cout,
                                    cout, 3, stride))
            H = H // stride
            shapes.append(ConvShape(batch, H, cout, cout, 3, 1))
            if b == 0 and cin != cout:
                shapes.append(ConvShape(batch, H * stride, cin, cout, 1,
                                        stride))
            cin = cout
    if not unique:
        return shapes
    return list(dict.fromkeys(shapes))


def mobilenet_conv_shapes(batch: int = 128, image: int = 32,
                          unique: bool = True) -> List[ConvShape]:
    """Convolution geometries of the CIFAR MobileNetV2 in network order:
    the 3x3 stem, each block's 1x1 expand and project, the 1x1 head (the
    depthwise convs are not among them: no kernel of ``kernels/conv.py``
    runs them).  With ``unique=False`` every conv site is returned."""
    shapes: List[ConvShape] = [ConvShape(batch, image, 3, MBV2_STEM, 3, 1)]
    hw = image
    for cin, hidden, cout, stride, _ in mbv2_layout():
        shapes.append(ConvShape(batch, hw, cin, hidden, 1, 1))
        hw //= stride
        shapes.append(ConvShape(batch, hw, hidden, cout, 1, 1))
    shapes.append(ConvShape(batch, hw, mbv2_layout()[-1][2], MBV2_HEAD, 1, 1))
    if not unique:
        return shapes
    return list(dict.fromkeys(shapes))
