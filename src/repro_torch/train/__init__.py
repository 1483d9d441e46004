# Training and evaluation: losses, optimizers, image-quality metrics, the
# step factories of the paper's two models and of the LM family, the LM
# serving entry points, checkpoints and the fault-tolerant loop.
from .optimizer import Adam, AdamW, SGD, constant_lr, warmup_cosine, global_norm, clip_by_global_norm
from .losses import (
    bce_with_logits,
    chunked_cross_entropy,
    cross_entropy,
    pix2pix_d_loss,
    pix2pix_g_loss,
    yolo_loss,
)
from .metrics import box_iou, mse, psnr, ssim, to_uint8_range
from .steps import (
    greedy_generate,
    make_lm_decode_step,
    make_lm_prefill,
    make_lm_train_step,
    make_pix2pix_infer,
    make_pix2pix_train_step,
    make_yolo_train_step,
)
from .checkpoint import (
    AsyncCheckpointer,
    available_steps,
    gc_checkpoints,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from .loop import LoopConfig, LoopState, run_train_loop
