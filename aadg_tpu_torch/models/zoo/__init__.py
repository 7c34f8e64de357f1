"""The segmentation zoo of the PyTorch/CUDA port (port of the parts of
``aadg_tpu/models/zoo/`` that the repo's zoo experiment files reach):
ResNetV1c-50, HRNet-W18, MobileNetV3 and the UNet-S5-D16 backbone; the
FCN, PSP, Lite-R-ASPP and OCR heads; the encoder-decoder and cascade
segmentors and the builder from ``MODEL.NAME``/``MODEL.BACKBONE``.

Every segmentor is ``model(x, dropout=None) -> (logits, feature)``: NHWC
images in, NHWC logits at the input resolution and the last backbone
stage's spatial mean out. The models run in f32 with autocast off, as the
JAX builder states; submodules carry the flax module names for
``weights.from_flax``.
"""
