"""Training (reference L7: train_util.py / fp16_util.py, completed).

Counterpart of ``flair_tpu/train``: the training step (``loop``: diffusion
losses, gradients through the hand-written kernels' autograd Functions,
optax-rule AdamW, float32 EMA streams, microbatch accumulation) and the
host loop (``runner``: quartile logging, save / resume, skip-frame
interpolation).

    from flair_tpu_torch.diffusion import get_named_beta_schedule, make_diffusion
    from flair_tpu_torch.models.registry import get_model
    from flair_tpu_torch.pipeline.wrappers import wrap_bicubic_train
    from flair_tpu_torch.train import TrainConfig, TrainRunner

    d = make_diffusion(get_named_beta_schedule("face_bicubic", 2000))
    model = get_model("bicubic_unet", dtype=torch.bfloat16)
    runner = TrainRunner(d, wrap_bicubic_train(d, model), TrainConfig(),
                         model, ckpt_dir="ckpts")
    runner.run_loop(batches)  # dicts: x_start, low_res_input (B, T, H, W, 3)

The BlurUNet trains through ``wrap_blur_train`` on
``make_task_diffusion("gaussian", "1000")`` (batches may add
``rnn_input``); ``use_checkpoint=True`` in either model remats its blocks.
"""

from .loop import (
    AdamW,
    TrainConfig,
    TrainState,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from .runner import (
    TrainRunner,
    find_resume_checkpoint,
    interpolate_skipped_frames,
    log_loss_quartiles,
)
