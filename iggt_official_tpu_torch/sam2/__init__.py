"""SAM2 in the port (counterpart of `iggt_official_tpu/sam2/`).

Hiera trunk + FPN image encoder, prompt encoder, mask decoder, the memory
modules, `SAM2Base`, the image predictor and the automatic mask generator,
under the released checkpoint's module names; the video predictor, video IO
and the propagation benchmark (`python -m iggt_official_tpu_torch.sam2.benchmark`).
"""
