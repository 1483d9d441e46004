# Training and evaluation of the paper's two models: losses, optimizers,
# image-quality metrics and the step factories; and the LM serving entry points.
from .optimizer import Adam, AdamW, SGD, constant_lr, warmup_cosine, global_norm, clip_by_global_norm
from .losses import bce_with_logits, pix2pix_d_loss, pix2pix_g_loss, yolo_loss
from .metrics import box_iou, mse, psnr, ssim, to_uint8_range
from .steps import (
    greedy_generate,
    make_lm_decode_step,
    make_lm_prefill,
    make_pix2pix_infer,
    make_pix2pix_train_step,
    make_yolo_train_step,
)
