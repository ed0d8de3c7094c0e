"""Image classification nets (port of
``models/image/imageclassification/nets.py``): LeNet, ResNet-18/34/50/
101/152, Inception-v1, MobileNet, VGG-16/19, SqueezeNet, DenseNet-121/
161/169 and AlexNet, and ``ImageClassifier``, which builds one by name.

Each builder makes its layers in the reference's order, so the layers'
auto-names, and with them the variables' key paths, are the reference's
(``interop.load_jax_variables`` relies on it).  NHWC throughout;
Conv→BN→activation blocks, residual adds through ``Merge("sum")``, a
global-average-pool head.  ``stem="space_to_depth"`` packs 2x2 pixel
blocks into 12 channels before a 4x4/stride-1 stem conv;
``conv_padding="torch"`` pads the stride-2 convolutions and the stem
pool symmetrically (the torchvision alignment) where SAME would pad
0/1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from analytics_zoo_torch.models.image.common import ImageConfigure, ImageModel
from analytics_zoo_torch.pipeline.api.keras import Input, Model
from analytics_zoo_torch.pipeline.api.keras.layers import (
    Activation, AveragePooling2D, BatchNormalization, Convolution2D, Dense,
    Dropout, Flatten, GlobalAveragePooling2D, MaxPooling2D, Merge,
    SpaceToDepth2D, ZeroPadding2D,
)


def _conv_bn(x, filters, k, stride=1, act=True, border="same",
             torch_pad=False):
    """Conv→BN→activation.  ``act``: True = relu, a string = that
    activation, False = none.  ``torch_pad`` reproduces the torch/Caffe
    lineage's explicit SYMMETRIC padding (pad (k-1)//2 on both sides,
    then a valid conv): XLA's SAME pads asymmetrically under stride 2
    (e.g. 0/1 for k=3), which samples different pixel positions —
    imported torchvision checkpoints are only numerically faithful
    with the source's alignment.  For stride 1 the two are identical,
    so SAME is kept (one op instead of two)."""
    if torch_pad and stride > 1 and k > 1:
        p = (k - 1) // 2
        x = ZeroPadding2D((p, p))(x)
        border = "valid"
    x = Convolution2D(filters, k, k, subsample=(stride, stride),
                      border_mode=border, bias=False)(x)
    x = BatchNormalization()(x)
    if act:
        x = Activation("relu" if act is True else act)(x)
    return x


def _check_conv_padding(conv_padding: str) -> bool:
    """Validate the conv_padding option; returns the torch_pad flag."""
    if conv_padding not in ("same", "torch"):
        raise ValueError(f"conv_padding must be 'same' or 'torch', "
                         f"got {conv_padding!r}")
    return conv_padding == "torch"


def _check_variant(variant: str) -> bool:
    """Validate a 'zoo' | 'torchvision' variant option; returns True
    for the torchvision graph variant."""
    if variant not in ("zoo", "torchvision"):
        raise ValueError(f"variant must be 'zoo' or 'torchvision', "
                         f"got {variant!r}")
    return variant == "torchvision"


def _stem_pool(x, torch_pad: bool):
    """The 3x3/stride-2 stem maxpool shared by the conv7 families:
    torch alignment = zero-pad(1,1) + valid pool (post-ReLU inputs are
    >= 0, so zero padding never wins the max)."""
    if torch_pad:
        x = ZeroPadding2D((1, 1))(x)
        return MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                            border_mode="valid")(x)
    return MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                        border_mode="same")(x)


# ------------------------------------------------------------------ LeNet
def lenet(num_classes: int = 10,
          input_shape: Tuple[int, int, int] = (28, 28, 1)) -> Model:
    inp = Input(shape=input_shape)
    x = Convolution2D(6, 5, 5, border_mode="same",
                      activation="tanh")(inp)
    x = MaxPooling2D()(x)
    x = Convolution2D(12, 5, 5, activation="tanh")(x)
    x = MaxPooling2D()(x)
    x = Flatten()(x)
    x = Dense(100, activation="tanh")(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


# ----------------------------------------------------------------- ResNet
def _basic_block(x, filters, stride, torch_pad=False):
    shortcut = x
    y = _conv_bn(x, filters, 3, stride, torch_pad=torch_pad)
    y = _conv_bn(y, filters, 3, 1, act=False)
    if stride != 1 or x.shape[-1] != filters:
        shortcut = _conv_bn(x, filters, 1, stride, act=False)
    out = Merge(mode="sum")([y, shortcut])
    return Activation("relu")(out)


def _bottleneck_block(x, filters, stride, torch_pad=False):
    shortcut = x
    y = _conv_bn(x, filters, 1, 1)
    y = _conv_bn(y, filters, 3, stride, torch_pad=torch_pad)
    y = _conv_bn(y, 4 * filters, 1, 1, act=False)
    if stride != 1 or x.shape[-1] != 4 * filters:
        shortcut = _conv_bn(x, 4 * filters, 1, stride, act=False)
    out = Merge(mode="sum")([y, shortcut])
    return Activation("relu")(out)


_RESNET_SPECS = {
    18: (_basic_block, (2, 2, 2, 2)),
    34: (_basic_block, (3, 4, 6, 3)),
    50: (_bottleneck_block, (3, 4, 6, 3)),
    101: (_bottleneck_block, (3, 4, 23, 3)),
    152: (_bottleneck_block, (3, 8, 36, 3)),
}


def resnet(depth: int = 50, num_classes: int = 1000,
           input_shape: Tuple[int, int, int] = (224, 224, 3),
           stem: str = "conv7", conv_padding: str = "same") -> Model:
    """ResNet for ImageNet-scale inputs (TrainImageNet.scala recipe).

    ``stem="conv7"`` is the classic 7x7/stride-2 stem; ``"space_to_depth"``
    is the MLPerf formulation of it (2x2 pixel blocks packed into 12
    channels, then a 4x4/stride-1 conv whose 8x8-pixel receptive field
    covers the 7x7 original) — same output shape and capacity, a wider
    contraction for the matrix units than 3 channels give.

    ``conv_padding="torch"`` uses the torch/Caffe lineage's explicit
    symmetric padding on the stem, the stem maxpool, and every
    stride-2 3x3 conv (see ``_conv_bn``) — the alignment published
    torchvision checkpoints were trained with (the block layout here
    already matches torchvision's v1.5: stride on the 3x3).  The
    default SAME padding is what you want when training from scratch
    (fewer ops, identical capacity).
    """
    block, reps = _RESNET_SPECS[depth]
    torch_pad = _check_conv_padding(conv_padding)
    inp = Input(shape=input_shape)
    if stem == "space_to_depth":
        x = SpaceToDepth2D(2)(inp)
        x = _conv_bn(x, 64, 4, 1)
    elif stem == "conv7":
        x = _conv_bn(inp, 64, 7, 2, torch_pad=torch_pad)
    else:
        raise ValueError(f"unknown stem {stem!r}; "
                         "expected 'conv7' or 'space_to_depth'")
    x = _stem_pool(x, torch_pad)
    filters = 64
    for stage, n in enumerate(reps):
        for i in range(n):
            stride = 2 if (stage > 0 and i == 0) else 1
            x = block(x, filters, stride, torch_pad=torch_pad)
        filters *= 2
    x = GlobalAveragePooling2D()(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


# ------------------------------------------------------------ Inception-v1
def _inception_module(x, f1, f3r, f3, f5r, f5, proj, b5_k=5):
    b1 = _conv_bn(x, f1, 1)
    b3 = _conv_bn(_conv_bn(x, f3r, 1), f3, 3)
    b5 = _conv_bn(_conv_bn(x, f5r, 1), f5, b5_k)
    bp = MaxPooling2D(pool_size=(3, 3), strides=(1, 1),
                      border_mode="same")(x)
    bp = _conv_bn(bp, proj, 1)
    return Merge(mode="concat", concat_axis=-1)([b1, b3, b5, bp])


def inception_v1(num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 variant: str = "zoo") -> Model:
    """GoogLeNet / Inception-v1 (examples/inception/Train.scala:31
    workload).

    ``variant="torchvision"`` reproduces torchvision's ``googlenet``
    graph exactly so published checkpoints import faithfully: the
    explicit pad-3 stem alignment, and a 3x3 kernel on the "5x5"
    branch (torchvision inherited that substitution from the TF-slim
    checkpoint it ported; the published weights have 3x3 shapes).
    The stride-2 maxpools stay ``same`` — on this net's even extents
    SAME's right-only padding selects the same windows as
    torchvision's ceil_mode, and zero padding never wins a max over
    post-ReLU inputs.  The aux towers are inference-irrelevant and
    not built; the importer skips their checkpoint modules."""
    tv = _check_variant(variant)
    if tv and (input_shape[0] % 32 or input_shape[1] % 32):
        # the SAME-pool == ceil_mode-pool equivalence (docstring) holds
        # only while every stride-2 stage sees an even extent; 5
        # halvings -> multiples of 32 keep the whole stack even
        raise ValueError(
            "variant='torchvision' needs input height/width divisible "
            f"by 32 for checkpoint-faithful pooling; got "
            f"{tuple(input_shape[:2])}")
    b5_k = 3 if tv else 5
    inp = Input(shape=input_shape)
    x = _conv_bn(inp, 64, 7, 2, torch_pad=tv)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _conv_bn(x, 64, 1)
    x = _conv_bn(x, 192, 3)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_module(x, 64, 96, 128, 16, 32, 32,
                          b5_k=b5_k)                      # 3a
    x = _inception_module(x, 128, 128, 192, 32, 96, 64,
                          b5_k=b5_k)                      # 3b
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_module(x, 192, 96, 208, 16, 48, 64,
                          b5_k=b5_k)                      # 4a
    x = _inception_module(x, 160, 112, 224, 24, 64, 64,
                          b5_k=b5_k)                      # 4b
    x = _inception_module(x, 128, 128, 256, 24, 64, 64,
                          b5_k=b5_k)                      # 4c
    x = _inception_module(x, 112, 144, 288, 32, 64, 64,
                          b5_k=b5_k)                      # 4d
    x = _inception_module(x, 256, 160, 320, 32, 128, 128,
                          b5_k=b5_k)                      # 4e
    # torchvision's maxpool4 is kernel-2/stride-2 (not 3x3)
    pool4 = (2, 2) if tv else (3, 3)
    x = MaxPooling2D(pool_size=pool4, strides=(2, 2),
                     border_mode="same")(x)
    x = _inception_module(x, 256, 160, 320, 32, 128, 128,
                          b5_k=b5_k)                      # 5a
    x = _inception_module(x, 384, 192, 384, 48, 128, 128,
                          b5_k=b5_k)                      # 5b
    x = GlobalAveragePooling2D()(x)
    x = Dropout(0.2 if tv else 0.4)(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


def mobilenet(num_classes: int = 1000,
              input_shape: Tuple[int, int, int] = (224, 224, 3),
              alpha: float = 1.0, activation: str = "relu") -> Model:
    """MobileNet-v1 (the published "mobilenet" family of
    ImageClassificationConfig.scala): each block is depthwise 3x3 →
    BN → act → pointwise 1x1 → BN → act — BOTH nonlinearities, per
    the paper (a fused separable conv would be a low-rank factorized
    conv, not MobileNet).  ``activation="relu6"`` matches the
    published keras-applications weights (XLA SAME padding already
    matches keras's zero-pad(0,1)+valid alignment on stride 2)."""
    def dw_block(x, in_ch, out_ch, stride):
        # depthwise: one 3x3 filter per input channel (groups=in_ch)
        x = Convolution2D(in_ch, 3, 3, subsample=(stride, stride),
                          border_mode="same", bias=False,
                          groups=in_ch)(x)
        x = BatchNormalization()(x)
        x = Activation(activation)(x)
        x = Convolution2D(out_ch, 1, 1, bias=False)(x)
        x = BatchNormalization()(x)
        return Activation(activation)(x)

    inp = Input(shape=input_shape)
    ch = int(32 * alpha)
    x = _conv_bn(inp, ch, 3, 2, act=activation)
    for filters, stride in ((64, 1), (128, 2), (128, 1), (256, 2),
                            (256, 1), (512, 2), (512, 1), (512, 1),
                            (512, 1), (512, 1), (512, 1), (1024, 2),
                            (1024, 1)):
        out_ch = int(filters * alpha)
        x = dw_block(x, ch, out_ch, stride)
        ch = out_ch
    x = GlobalAveragePooling2D()(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


def vgg(depth: int = 16, num_classes: int = 1000,
        input_shape: Tuple[int, int, int] = (224, 224, 3)) -> Model:
    """VGG-16/19 (published "vgg-16"/"vgg-19")."""
    cfg = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}[depth]
    inp = Input(shape=input_shape)
    x = inp
    filters = 64
    for n_convs in cfg:
        for _ in range(n_convs):
            x = Convolution2D(filters, 3, 3, border_mode="same",
                              activation="relu")(x)
        x = MaxPooling2D(pool_size=(2, 2))(x)
        filters = min(filters * 2, 512)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


def squeezenet(num_classes: int = 1000,
               input_shape: Tuple[int, int, int] = (224, 224, 3)
               ) -> Model:
    """SqueezeNet v1.1 (published "squeezenet")."""
    def fire(x, squeeze, expand):
        s = Convolution2D(squeeze, 1, 1, activation="relu")(x)
        e1 = Convolution2D(expand, 1, 1, activation="relu")(s)
        e3 = Convolution2D(expand, 3, 3, border_mode="same",
                           activation="relu")(s)
        return Merge(mode="concat")([e1, e3])

    inp = Input(shape=input_shape)
    x = Convolution2D(64, 3, 3, subsample=(2, 2),
                      activation="relu")(inp)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = fire(x, 16, 64)
    x = fire(x, 16, 64)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = fire(x, 32, 128)
    x = fire(x, 32, 128)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = fire(x, 48, 192)
    x = fire(x, 48, 192)
    x = fire(x, 64, 256)
    x = fire(x, 64, 256)
    x = Dropout(0.5)(x)
    # the paper (and torchvision) applies ReLU to conv10 before the
    # global pool — outputs are non-negative class activations
    x = Convolution2D(num_classes, 1, 1, activation="relu")(x)
    out = GlobalAveragePooling2D()(x)
    return Model(inp, out)


def densenet(depth: int = 121, num_classes: int = 1000,
             input_shape: Tuple[int, int, int] = (224, 224, 3),
             growth_rate: int = None, blocks: Sequence[int] = None,
             conv_padding: str = "same") -> Model:
    """DenseNet-121/161/169 (incl. the published "densenet-161"; block
    configs and growth rates per the DenseNet paper).  ``blocks``
    overrides the per-stage layer counts (custom/test-scale configs).

    ``conv_padding="torch"``: explicit symmetric padding on the stem
    conv + maxpool (the only stride-2 ops with a kernel > 1), matching
    torchvision checkpoints — every other conv is 1x1 or stride-1
    3x3/SAME, which already agree."""
    try:
        default_blocks, default_growth = {
            121: ((6, 12, 24, 16), 32),
            161: ((6, 12, 36, 24), 48),
            169: ((6, 12, 32, 32), 32),
        }[depth]
    except KeyError:
        raise ValueError(f"densenet depth must be 121/161/169, "
                         f"got {depth}") from None
    blocks = tuple(blocks) if blocks is not None else default_blocks
    growth_rate = growth_rate or default_growth

    def dense_block(x, n_layers):
        for _ in range(n_layers):
            y = BatchNormalization()(x)
            y = Activation("relu")(y)
            y = Convolution2D(4 * growth_rate, 1, 1, bias=False)(y)
            y = BatchNormalization()(y)
            y = Activation("relu")(y)
            y = Convolution2D(growth_rate, 3, 3, border_mode="same",
                              bias=False)(y)
            x = Merge(mode="concat")([x, y])
        return x

    def transition(x, out_ch):
        x = BatchNormalization()(x)
        x = Activation("relu")(x)
        x = Convolution2D(out_ch, 1, 1, bias=False)(x)
        return AveragePooling2D(pool_size=(2, 2))(x)

    torch_pad = _check_conv_padding(conv_padding)
    inp = Input(shape=input_shape)
    x = _conv_bn(inp, 2 * growth_rate, 7, 2, torch_pad=torch_pad)
    x = _stem_pool(x, torch_pad)
    ch = 2 * growth_rate
    for i, n_layers in enumerate(blocks):
        x = dense_block(x, n_layers)
        ch += n_layers * growth_rate
        if i < len(blocks) - 1:
            ch //= 2
            x = transition(x, ch)
    x = BatchNormalization()(x)
    x = Activation("relu")(x)
    x = GlobalAveragePooling2D()(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


def alexnet(num_classes: int = 1000,
            input_shape: Tuple[int, int, int] = (227, 227, 3),
            variant: str = "zoo") -> Model:
    """AlexNet (published "alexnet"; LRN replaced by BN, the modern
    equivalent).

    ``variant="torchvision"`` builds torchvision's exact graph instead
    (224 input, pad-2 stem, no norm layers, dropout-first classifier)
    so published ``alexnet .pth`` checkpoints import faithfully."""
    if _check_variant(variant):
        if input_shape == (227, 227, 3):
            input_shape = (224, 224, 3)    # torchvision's input size
        inp = Input(shape=input_shape)
        x = ZeroPadding2D((2, 2))(inp)
        x = Convolution2D(64, 11, 11, subsample=(4, 4),
                          activation="relu")(x)
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
        x = Convolution2D(192, 5, 5, border_mode="same",
                          activation="relu")(x)
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
        x = Convolution2D(384, 3, 3, border_mode="same",
                          activation="relu")(x)
        x = Convolution2D(256, 3, 3, border_mode="same",
                          activation="relu")(x)
        x = Convolution2D(256, 3, 3, border_mode="same",
                          activation="relu")(x)
        x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
        x = Flatten()(x)
        x = Dropout(0.5)(x)
        x = Dense(4096, activation="relu")(x)
        x = Dropout(0.5)(x)
        x = Dense(4096, activation="relu")(x)
        out = Dense(num_classes)(x)
        return Model(inp, out)
    inp = Input(shape=input_shape)
    x = Convolution2D(96, 11, 11, subsample=(4, 4),
                      activation="relu")(inp)
    x = BatchNormalization()(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = Convolution2D(256, 5, 5, border_mode="same",
                      activation="relu")(x)
    x = BatchNormalization()(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = Convolution2D(384, 3, 3, border_mode="same",
                      activation="relu")(x)
    x = Convolution2D(384, 3, 3, border_mode="same",
                      activation="relu")(x)
    x = Convolution2D(256, 3, 3, border_mode="same",
                      activation="relu")(x)
    x = MaxPooling2D(pool_size=(3, 3), strides=(2, 2))(x)
    x = Flatten()(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    x = Dense(4096, activation="relu")(x)
    x = Dropout(0.5)(x)
    out = Dense(num_classes)(x)
    return Model(inp, out)


_BUILDERS = {
    "lenet": lenet,
    "resnet-18": lambda **kw: resnet(18, **kw),
    "resnet-34": lambda **kw: resnet(34, **kw),
    "resnet-50": lambda **kw: resnet(50, **kw),
    "resnet-101": lambda **kw: resnet(101, **kw),
    "inception-v1": inception_v1,
    "mobilenet": mobilenet,
    "vgg-16": lambda **kw: vgg(16, **kw),
    "vgg-19": lambda **kw: vgg(19, **kw),
    "squeezenet": squeezenet,
    "densenet-121": lambda **kw: densenet(121, **kw),
    "densenet-161": lambda **kw: densenet(161, **kw),
    "densenet-169": lambda **kw: densenet(169, **kw),
    "alexnet": alexnet,
}


def _pretrained_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: importing published checkpoints (torchvision .pth, Keras "
        ".h5) is not ported to the PyTorch package yet; it waits for "
        "checkpoint files in the repository (ROADMAP.md, port queue 1)")


def load_pretrained(model, src, source: str = None, **kwargs):
    raise _pretrained_not_ported("load_pretrained")


def pretrained_configure(model_name: str, source: str, **kwargs):
    raise _pretrained_not_ported("pretrained_configure")


class ImageClassifier(ImageModel):
    """Build a named classification net (the by-name loading surface of
    ImageClassificationConfig.scala): ``model_name`` one of
    ``_BUILDERS``, with ``num_classes`` and ``input_shape``.
    ``pretrained=`` (a published checkpoint) raises: not ported yet."""

    def __init__(self, model_name: str = "resnet-50",
                 num_classes: int = 1000,
                 input_shape: Tuple[int, int, int] = (224, 224, 3),
                 config: ImageConfigure = None,
                 pretrained=None, source: str = None):
        if model_name not in _BUILDERS:
            raise ValueError(
                f"unknown model {model_name!r}; "
                f"available: {sorted(_BUILDERS)}")
        if pretrained is not None:
            raise _pretrained_not_ported("ImageClassifier(pretrained=...)")
        self._builder = _BUILDERS[model_name]
        self._kw = dict(num_classes=num_classes, input_shape=input_shape)
        super().__init__(config)

    def build_model(self):
        return self._builder(**self._kw)
