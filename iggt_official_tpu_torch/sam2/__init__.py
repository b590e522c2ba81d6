"""SAM2 image path of the port (counterpart of `iggt_official_tpu/sam2/`).

Hiera trunk + FPN image encoder, prompt encoder, mask decoder, the memory
modules, `SAM2Base`, the image predictor and the automatic mask generator,
under the released checkpoint's module names.  The video predictor, video IO
and the SAM2 benchmark are not ported yet.
"""
