"""The segmentation zoo of the PyTorch/CUDA port (port of
``aadg_tpu/models/zoo/``'s models): ResNetV1c-50/101, ResNeXt-50/101,
HRNet-W18/32/48, MobileNetV3 and the UNet-S5-D16 backbone; the FPN neck;
every decode head of the JAX builder (conv and pyramid heads, the
attention heads, PointRend's point head); the encoder-decoder, cascade and
PointRend segmentors and the builder from ``MODEL.NAME``/``MODEL.BACKBONE``.

Every segmentor is ``model(x, dropout=None) -> (logits, feature)``: NHWC
images in, NHWC logits at the input resolution and the last feature's
spatial mean out. The models run in f32 with autocast off, as the JAX
builder states; submodules carry the flax module names for
``weights.from_flax``.
"""
