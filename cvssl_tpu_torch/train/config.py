"""Training configuration (port of ``cvssl_tpu/train/config.py``).

Same fields, names and defaults as the JAX ``TrainConfig``, so one set of
flags drives either package. Fields that only shape the JAX program on a
TPU are accepted and inert here:

* ``s2d_levels``, ``s2d_loss``: space-to-depth reformulation for the TPU's
  128-wide lanes; the port runs the plain UNet.
* ``rng_impl``: JAX PRNG implementation; the port draws from
  ``torch.Generator``s.
* ``compile_cache``: XLA's persistent compilation cache.
* ``dcn_slices``: mesh folding across TPU hosts.
* ``num_workers``: host data-pipeline workers; as in JAX, the host
  pipeline loads samples one after another, on purpose, in one prefetch
  thread, so that the generator it shares with the sampler is drawn in a
  fixed order (``data/pipeline.py``).

``num_devices`` must be None or 1: the port trains on one card so far.
``fused_loss`` must be None or True: the fused CE+Dice kernel is always on.
``pretrained_ckpt``: a local ``.pth`` that ``Engine.init_state`` loads
into each model it fits (``models/cnn_checkpoint.py``: Res2Net into
``preunet``'s encoder, EfficientNet-B3 into ``efficient_unet``'s, Swin-tiny
into SwinUnet), before the teachers are copied.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class TrainConfig:
    # paths / bookkeeping
    root_path: str = "../data/ACDC"
    exp: str = "ACDC/experiment"
    model: str = "unet"
    model2: str = "swin_unet"          # second model for dual-model methods
    method: str = "supervised"
    snapshot_root: str = "../model"

    # core hyperparameters (reference defaults)
    num_classes: int = 4
    in_channels: int = 1
    max_iterations: int = 30000
    batch_size: int = 24
    base_lr: float = 0.01
    patch_size: Tuple[int, ...] = (256, 256)
    patch_size2: Optional[Tuple[int, ...]] = None
    seed: int = 1337
    deterministic: bool = True

    # semi-supervision
    labeled_bs: int = 12
    labeled_num: int = 7               # patients (slice-count table);
                                       # 3D: labeled volumes
    labeled_slices_override: Optional[int] = None  # bypass the table
    total_num: Optional[int] = None    # unlabeled pool size (3D: 250)
    ema_decay: float = 0.99
    consistency: float = 0.1
    consistency1: float = 1.0          # contrastive_consistency weights
    consistency2: float = 0.1
    consistency_rampup: float = 200.0
    consistency_type: str = "mse"
    conf_thresh: float = 0.8           # FixMatch confidence threshold

    # method extras
    uncertainty_T: int = 8             # UAMT MC passes
    ict_alpha: float = 0.2             # ICT Beta(alpha, alpha)
    dan_lr: float = 1e-4               # discriminator Adam LR

    # engine
    device_data: bool = True           # 2D: dataset resident on the card,
                                       # augmentation inside the step;
                                       # False: the host pipeline
    # fused CE+Dice kernel (ops/fused_ce_dice.py): always on, as the port
    # has no s2d grouped-logits losses, the only case the JAX package turns
    # it off for. None or True; False raises.
    fused_loss: Optional[bool] = None
    scan_steps: int = 1                # steps per Engine.train_steps call
    log_every: int = 20
    val_every: int = 200
    ckpt_every: int = 3000
    num_workers: int = 8
    rng_impl: str = "auto"             # inert (JAX PRNG implementation)
    # compute dtype. "auto" = bfloat16 on CUDA, float32 on CPU; parameters,
    # BatchNorm statistics and the losses stay float32.
    dtype: str = "auto"
    s2d_levels: Optional[int] = None   # inert (TPU space-to-depth levels)
    s2d_loss: str = "auto"             # inert (TPU grouped-logits losses)
    dim: int = 2                       # 2 or 3 (dataset/model family)
    num_devices: Optional[int] = None  # None or 1
    dcn_slices: Optional[int] = None   # inert (TPU mesh folding)
    profile_dir: Optional[str] = None  # not ported yet: fit raises
    compile_cache: Optional[str] = "auto"  # inert (XLA compilation cache)
    vit_kwargs: Optional[dict] = None  # SwinUnet constructor overrides
    pretrained_ckpt: Optional[str] = None  # local .pth (cnn_checkpoint)

    def __post_init__(self):
        if self.num_devices not in (None, 1):
            raise ValueError("the port trains on one device: num_devices "
                             f"must be None or 1, got {self.num_devices}")
        if self.fused_loss is False:
            raise ValueError("the port always runs the fused CE+Dice "
                             "kernel: fused_loss must be None or True")

    @property
    def labeled_slices(self) -> int:
        """Labeled train slices: the override, else the dataset's
        patients-to-slices table. 2D only: at ``dim=3`` ``labeled_num``
        counts volumes and ``total_num`` the unlabeled pool (JAX
        ``engine.build_3d_data``)."""
        if self.labeled_slices_override is not None:
            return self.labeled_slices_override
        from cvssl_tpu_torch.data.datasets import patients_to_slices
        return patients_to_slices(self.root_path, self.labeled_num)

    def snapshot_path(self) -> str:
        """``{snapshot_root}/{exp}_{labeled_num}_labeled/{model}``."""
        return os.path.join(self.snapshot_root,
                            f"{self.exp}_{self.labeled_num}_labeled",
                            self.model)

    def compute_dtype(self, device) -> torch.dtype:
        """Resolve ``dtype`` for ``device``: "auto" is bfloat16 on CUDA and
        float32 elsewhere. Only the nets of ``COMPUTE_DTYPE_NETS`` compute
        in it (:meth:`model_dtype`)."""
        dt = self.dtype
        if dt == "auto":
            dt = "bfloat16" if torch.device(device).type == "cuda" \
                else "float32"
        if dt not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        return getattr(torch, dt)

    # the nets whose JAX module takes the compute dtype
    # (``cvssl_tpu.train.config.TrainConfig.model_kwargs``)
    COMPUTE_DTYPE_NETS = ("unet", "swin_unet", "ViT_Seg", "unet_3D",
                          "unet_3D_dv_semi")
    VIT_NETS = ("swin_unet", "ViT_Seg")
    # the 3D ViTs: built for the patch (UNETR's position table, SwinUNETR's
    # windows), as JAX's init at the sample batch sizes them
    VIT_NETS_3D = ("unetr", "swinunetr")

    def model_kwargs(self, net_type: str) -> dict:
        """Constructor arguments of ``net_type``: for the ViT slot the
        training patch as ``img_size`` (the reference builds ``ViT_seg``
        with ``img_size=args.patch_size``; the port's SwinUnet fixes each
        stage's window from it), then ``vit_kwargs``; for ``unetr`` and
        ``swinunetr`` the patch as ``img_size``; nothing for the other
        nets. The dtype is not among them: it is :meth:`model_dtype`, under
        which the engine autocasts each model."""
        if net_type in self.VIT_NETS:
            return {"img_size": tuple(self.patch_size),
                    **(self.vit_kwargs or {})}
        if net_type in self.VIT_NETS_3D:
            return {"img_size": tuple(self.patch_size)}
        return {}

    def model_dtype(self, net_type: str, device) -> torch.dtype:
        """The dtype ``net_type`` computes in on ``device``: the resolved
        compute dtype for the plain UNet, SwinUnet and the 3D UNets,
        float32 for every other net (the UNet variants, the discriminators
        and the zoo's ``vnet``, ``voxresnet``, ``attention_unet`` and
        ``nnUNet`` have no dtype field in JAX, whose ``model_kwargs`` gives
        them none, so they run in float32 whatever ``dtype`` says), and
        the 3D ViTs ``unetr`` and ``swinunetr``, also without a dtype in
        JAX)."""
        if net_type in self.COMPUTE_DTYPE_NETS:
            return self.compute_dtype(device)
        return torch.float32

    def fused_loss_on(self) -> bool:
        """The fused CE+Dice kernel is always on in the port."""
        return True
