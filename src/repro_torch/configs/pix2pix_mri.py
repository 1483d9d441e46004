"""The paper's own model: Pix2Pix CT->MRI (256x256), a copy of
``repro.configs.pix2pix_mri``: three deconv variants plus a
batch-independent serving variant (instance norm instead of batch stats)."""
import dataclasses

from ..models.pix2pix import Pix2PixConfig

FAMILY = "pix2pix"

CONFIG = Pix2PixConfig(name="pix2pix-mri", img_size=256, deconv_mode="padded")
CONFIG_CROPPING = dataclasses.replace(CONFIG, deconv_mode="cropping")
CONFIG_CONV = dataclasses.replace(CONFIG, deconv_mode="conv")
CONFIG_MERGEABLE = dataclasses.replace(CONFIG_CROPPING, name="pix2pix-mri-in", norm="instance")

SMOKE = Pix2PixConfig(name="pix2pix-smoke", img_size=64, base=8, deconv_mode="cropping")
SMOKE_MERGEABLE = dataclasses.replace(SMOKE, name="pix2pix-smoke-in", norm="instance")
