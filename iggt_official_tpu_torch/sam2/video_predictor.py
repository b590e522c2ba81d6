"""SAM2 video predictor: interactive prompting and mask propagation
(counterpart of `iggt_official_tpu/sam2/video_predictor.py`,
`sam2/sam2_video_predictor.py:36-626` and `sam2/modeling/sam2_base.py:491-907`).

- `init_state` loads the frames (`video_io.load_frame_source`) onto the
  model's device and sets up per-object storage (conditioning and
  non-conditioning frame outputs).
- `add_new_points_or_box` runs the SAM heads on a conditioning frame with the
  object's accumulated clicks (or box), without memory.
- `propagate_in_video` streams over the frames, conditioning each frame's
  features on the memory bank: the conditioning frames' memories at temporal
  position 0, the last ``num_maskmem - 1`` frames at positions 1..6 with the
  learned temporal embeddings, and the object pointers with sine temporal
  encodings, through `SAM2Base.propagate_step`.
- `propagate_in_video_batch` runs the same propagation as one loop over the
  frames that carries fixed-shape ring buffers of memories, positions and
  pointers on the device (the JAX package's `lax.scan`), when every object
  is prompted on the same single frame and propagation starts there; any
  other prompt pattern falls back to the streaming loop, as in the JAX
  package.

Frame and memory bookkeeping is host Python (as in the reference); per-frame
outputs (memory features, object pointers, mask logits) stay on the device,
and only the masks yielded leave it, if the caller converts them.  The batch
dimension is per object.  Every Hiera attention of the image encoder goes
through the flash kernel on the card (`sam2/hiera.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from iggt_official_tpu_torch.sam2.base import SAM2Base, high_res_features
from iggt_official_tpu_torch.sam2.transforms import SAM2Transforms


class SAM2VideoPredictor:
    def __init__(self, model: SAM2Base, mask_threshold: float = 0.0,
                 fill_hole_area: float = 0.0):
        self.model = model
        self.cfg = model.cfg
        self.device = next(model.parameters()).device
        self.mask_threshold = mask_threshold
        self._transforms = SAM2Transforms(self.cfg.image_size, mask_threshold,
                                          fill_hole_area, 0.0)
        self._zero_slot = None   # (1, n_spatial, mem_dim) zeros, made on first use
        self._zero_ptr = None    # (d_model,) zero object pointer

    # ------------------------------------------------------------------
    def init_state(self, images, async_loading_frames: bool = False) -> Dict:
        """images: a sequence of HWC RGB frames, a JPEG-frame directory or an
        MP4 path.  Frames go to the device once; with
        ``async_loading_frames`` (JPEG folders) a decode thread fills chunks
        that are uploaded on first use, so the session starts after frame 0
        decodes."""
        from iggt_official_tpu_torch.sam2.video_io import load_frame_source

        source = load_frame_source(images, self._transforms, self.device,
                                   async_loading_frames=async_loading_frames)
        return {
            "images": source,
            "num_frames": source.num_frames,
            "orig_hw": source.orig_hw,
            "cached_features": {},
            # per object id:
            "point_inputs_per_obj": {},
            "cond_frame_outputs": {},
            "non_cond_frame_outputs": {},
            "obj_ids": [],
        }

    def reset_state(self, state: Dict) -> None:
        state["point_inputs_per_obj"].clear()
        state["cond_frame_outputs"].clear()
        state["non_cond_frame_outputs"].clear()
        state["obj_ids"].clear()

    # ------------------------------------------------------------------
    def _get_image_features(self, state: Dict, frame_idx: int):
        cache = state["cached_features"]
        if frame_idx not in cache:
            img = state["images"].get(frame_idx)[None]
            cache[frame_idx] = self.model.forward_image(img)
            # bounded (the reference offloads to the CPU; this evicts the oldest)
            if len(cache) > 2 * self.cfg.num_maskmem + 2:
                del cache[min(k for k in cache if k != frame_idx)]
        return cache[frame_idx]

    @staticmethod
    def _obj_store(state: Dict, obj_id: int, key: str) -> Dict:
        return state[key].setdefault(obj_id, {})

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def add_new_points_or_box(self, state: Dict, frame_idx: int, obj_id: int,
                              points: Optional[np.ndarray] = None,
                              labels: Optional[np.ndarray] = None,
                              box: Optional[np.ndarray] = None,
                              clear_old_points: bool = True):
        """Interactive prompt on a conditioning frame
        (`sam2_video_predictor.py:155-376`).  Returns (frame_idx, obj_ids,
        the object's mask logits (1, H, W) at the video's size, on the
        device)."""
        if obj_id not in state["obj_ids"]:
            state["obj_ids"].append(obj_id)
        coords_list, labels_list = [], []
        if box is not None:
            b = self._transforms.transform_boxes(np.asarray(box, np.float32), normalize=True,
                                                 orig_hw=state["orig_hw"]).reshape(2, 2)
            coords_list.append(b)
            labels_list.append(np.asarray([2, 3], np.int32))
        if points is not None:
            pts = self._transforms.transform_coords(np.asarray(points, np.float32),
                                                    normalize=True, orig_hw=state["orig_hw"])
            coords_list.append(pts.reshape(-1, 2))
            labels_list.append(np.asarray(labels, np.int32).reshape(-1))
        store = self._obj_store(state, obj_id, "point_inputs_per_obj")
        old = store.get(frame_idx)
        coords = np.concatenate(coords_list)[None]
        labs = np.concatenate(labels_list)[None]
        if old is not None and not clear_old_points:
            coords = np.concatenate([old["point_coords"], coords], axis=1)
            labs = np.concatenate([old["point_labels"], labs], axis=1)
        point_inputs = {"point_coords": coords, "point_labels": labs}
        store[frame_idx] = point_inputs
        out = self._run_single_frame(state, frame_idx, obj_id, point_inputs=point_inputs)
        self._obj_store(state, obj_id, "cond_frame_outputs")[frame_idx] = out
        self._obj_store(state, obj_id, "non_cond_frame_outputs").pop(frame_idx, None)
        masks = self._transforms.postprocess_masks(out["pred_masks"][None], state["orig_hw"])
        return frame_idx, state["obj_ids"], masks[0]

    # ------------------------------------------------------------------
    @staticmethod
    def _frames(state: Dict, start: int, max_frame_num_to_track: Optional[int],
                reverse: bool) -> List[int]:
        num_frames = state["num_frames"]
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end = max(start - max_frame_num_to_track, 0)
            return list(range(start, end - 1, -1))
        end = min(start + max_frame_num_to_track, num_frames - 1)
        return list(range(start, end + 1))

    @torch.inference_mode()
    def propagate_in_video(self, state: Dict, start_frame_idx: Optional[int] = None,
                           max_frame_num_to_track: Optional[int] = None,
                           reverse: bool = False):
        """Streaming mask propagation (`sam2_video_predictor.py:540-626`).
        Yields (frame_idx, obj_ids, mask logits (num_obj, H, W) on the device)."""
        obj_ids = list(state["obj_ids"])
        assert obj_ids, "add prompts before propagating"
        if start_frame_idx is None:
            start_frame_idx = min(min(d.keys()) for d in state["cond_frame_outputs"].values()
                                  if d)
        for frame_idx in self._frames(state, start_frame_idx, max_frame_num_to_track, reverse):
            per_obj_masks = []
            for obj_id in obj_ids:
                cond = self._obj_store(state, obj_id, "cond_frame_outputs")
                non_cond = self._obj_store(state, obj_id, "non_cond_frame_outputs")
                if frame_idx in cond:
                    out = cond[frame_idx]
                else:
                    out = self._run_propagate_frame(state, frame_idx, obj_id, reverse=reverse)
                    non_cond[frame_idx] = out
                per_obj_masks.append(out["pred_masks"])
            masks = self._transforms.postprocess_masks(torch.stack(per_obj_masks),
                                                       state["orig_hw"])[:, 0]
            yield frame_idx, obj_ids, masks

    # ------------------------------------------------------------------
    def _propagate_frames(self, frames: List[int], state: Dict, cond_mem, cond_pos,
                          cond_ptr, max_ptrs: int, multi: bool):
        """The JAX package's whole-video `lax.scan` as a loop over ``frames``:
        the memory bank and object pointers are fixed-shape ring buffers on
        the device (newest first), and each frame runs the image encoder and
        `propagate_step`.  cond_mem / cond_pos (B, hw, mem_dim) and cond_ptr
        (B, d_model) are the shared conditioning frame's outputs.  Returns the
        stacked (low-res masks, obj_ptr, object score logits, memory
        features, memory positions), one row per frame."""
        model, cfg = self.model, self.cfg
        dev = cond_mem.device
        B, hw_mem, md = cond_mem.shape
        R = cfg.num_maskmem - 1
        t_diff_max = max(max_ptrs - 1, 1)
        # slot p in 1..R holds the frame num_maskmem - p back; the
        # conditioning slot (t_pos 0) takes the last temporal row
        tpos_idx = torch.arange(cfg.num_maskmem - 1, -1, -1, device=dev)
        ring_mem = cond_mem.new_zeros((R, B, hw_mem, md))
        ring_pos = cond_mem.new_zeros((R, B, hw_mem, md))
        ring_ptr = cond_mem.new_zeros((max(max_ptrs - 1, 1), B, cond_ptr.shape[-1]))
        outs = []
        for n, f in enumerate(frames):
            backbone = model.forward_image(state["images"].get(f)[None])
            f1 = backbone["backbone_fpn"][-1]
            feats = f1.expand((B,) + f1.shape[1:])
            pos = backbone["vision_pos_enc"][-1]
            curr_pos = pos.reshape(1, -1, pos.shape[-1]).expand(B, -1, -1)
            hi = high_res_features(backbone, cfg)
            if hi is not None:
                hi = [h.expand((B,) + h.shape[1:]) for h in hi]
            # ring row r holds the non-conditioning frame n - 1 - r
            mem_slots = (cond_mem,) + tuple(ring_mem[R - p] for p in range(1, cfg.num_maskmem))
            pos_slots = (cond_pos,) + tuple(ring_pos[R - p] for p in range(1, cfg.num_maskmem))
            slot_valid = torch.from_numpy(
                np.concatenate([[True], np.arange(R - 1, -1, -1) < n])).to(dev)
            # pointers: conditioning first (t-diff n + 1), then the last
            # max_ptrs - 1 frames newest first (t-diff 1..)
            ptrs = torch.cat([cond_ptr[:, None], ring_ptr.transpose(0, 1)], dim=1)[:, :max_ptrs]
            ptr_pos_norm = torch.from_numpy(np.concatenate(
                [[n + 1], np.arange(1, max_ptrs)]).astype(np.float32) / t_diff_max).to(dev)
            n_valid = 1 + min(n, max_ptrs - 1)
            low, obj_ptr, obj_logits, mem_feats, mem_pos = model.propagate_step(
                feats, curr_pos, hi, mem_slots, pos_slots, tpos_idx, slot_valid, ptrs,
                ptr_pos_norm, n_valid, multi)
            new_mem = mem_feats.reshape(B, hw_mem, md)
            p = mem_pos.reshape(-1, hw_mem, md)
            new_pos = p.expand(B, hw_mem, md) if p.shape[0] == 1 else p
            ring_mem = torch.cat([new_mem[None], ring_mem[:-1]])
            ring_pos = torch.cat([new_pos[None], ring_pos[:-1]])
            ring_ptr = torch.cat([obj_ptr[None], ring_ptr[:-1]])
            outs.append((low, obj_ptr, obj_logits, new_mem, new_pos))
        return tuple(torch.stack(x) for x in zip(*outs))

    @torch.inference_mode()
    def propagate_in_video_batch(self, state: Dict, start_frame_idx: Optional[int] = None,
                                 max_frame_num_to_track: Optional[int] = None,
                                 reverse: bool = False):
        """`propagate_in_video`'s semantics through `_propagate_frames`.

        Needs every object prompted on the same single conditioning frame and
        propagation starting there (the usual VOS protocol); anything else
        falls back to the streaming loop.  Yields (frame_idx, obj_ids, masks)
        as `propagate_in_video` does."""
        obj_ids = list(state["obj_ids"])
        assert obj_ids, "add prompts before propagating"
        cond_sets = [tuple(sorted(state["cond_frame_outputs"].get(o, {}))) for o in obj_ids]
        cond = cond_sets[0]
        scannable = len(cond) == 1 and all(c == cond for c in cond_sets)
        if scannable and start_frame_idx is not None:
            scannable = start_frame_idx == cond[0]
        if not scannable:
            yield from self.propagate_in_video(state, start_frame_idx, max_frame_num_to_track,
                                               reverse)
            return
        cfg = self.cfg
        c = cond[0]
        rest = self._frames(state, c, max_frame_num_to_track, reverse)[1:]
        md = cfg.mem_dim
        conds = [state["cond_frame_outputs"][o][c] for o in obj_ids]
        cond_mem = torch.cat([o["maskmem_features"].reshape(1, -1, md) for o in conds])
        cond_pos = torch.cat([o["maskmem_pos_enc"].reshape(1, -1, md) for o in conds])
        cond_ptr = torch.stack([o["obj_ptr"] for o in conds])
        max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
        cond_masks = self._transforms.postprocess_masks(
            torch.stack([o["pred_masks"] for o in conds]), state["orig_hw"])[:, 0]
        if rest:
            low, ptr_all, logit_all, memf_all, memp_all = self._propagate_frames(
                rest, state, cond_mem, cond_pos, cond_ptr, max_ptrs,
                cfg.multimask_output_for_tracking)
            for ti, f in enumerate(rest):
                for bi, o in enumerate(obj_ids):
                    self._obj_store(state, o, "non_cond_frame_outputs")[f] = {
                        "maskmem_features": memf_all[ti, bi][None],
                        "maskmem_pos_enc": memp_all[ti, bi][None],
                        "pred_masks": low[ti, bi],
                        "obj_ptr": ptr_all[ti, bi],
                        "object_score_logits": logit_all[ti, bi],
                    }
            T, B = low.shape[:2]
            masks_all = self._transforms.postprocess_masks(
                low.reshape((T * B,) + low.shape[2:]), state["orig_hw"])
            masks_all = masks_all[:, 0].reshape((T, B) + masks_all.shape[2:])
        yield c, obj_ids, cond_masks
        for ti, f in enumerate(rest):
            yield f, obj_ids, masks_all[ti]

    # ------------------------------------------------------------------
    def _run_propagate_frame(self, state: Dict, frame_idx: int, obj_id: int,
                             reverse: bool = False) -> Dict:
        """A non-conditioning tracking step through `SAM2Base.propagate_step`:
        the host selects which device tensors feed the bank
        (`sam2_base.py:490-640`), the step assembles it and runs."""
        cfg = self.cfg
        cond = self._obj_store(state, obj_id, "cond_frame_outputs")
        non_cond = self._obj_store(state, obj_id, "non_cond_frame_outputs")
        if not cond:
            # no prompts yet: the no-memory path
            return self._run_single_frame(state, frame_idx, obj_id, point_inputs=None)
        backbone = self._get_image_features(state, frame_idx)
        feats = backbone["backbone_fpn"][-1]       # (1, h, w, C)
        pos = backbone["vision_pos_enc"][-1]
        hi = high_res_features(backbone, cfg)
        B, h, w, C = feats.shape
        curr_pos = pos.reshape(B, h * w, C)

        # spatial memory slots (`sam2_base.py:490-560`)
        t_and_prev = [(0, out) for _, out in sorted(cond.items())]
        for t_pos in range(1, cfg.num_maskmem):
            t_rel = cfg.num_maskmem - t_pos
            prev_idx = frame_idx + t_rel if reverse else frame_idx - t_rel
            out = non_cond.get(prev_idx)
            if out is None:
                out = cond.get(prev_idx)
                if out is not None and any(o is out for _, o in t_and_prev):
                    out = None
            if out is not None:
                t_and_prev.append((t_pos, out))
        t_and_prev = t_and_prev[: cfg.num_maskmem]
        md = cfg.mem_dim
        n_slots = cfg.num_maskmem
        mem_slots: List = [None] * n_slots
        pos_slots: List = [None] * n_slots
        tpos_idx = np.zeros(n_slots, np.int64)
        slot_valid = np.zeros(n_slots, bool)
        n_spatial = None
        for slot, (t_pos, prev) in enumerate(t_and_prev):
            mem_slots[slot] = prev["maskmem_features"].reshape(1, -1, md)
            pos_slots[slot] = prev["maskmem_pos_enc"].reshape(1, -1, md)
            n_spatial = mem_slots[slot].shape[1]
            tpos_idx[slot] = cfg.num_maskmem - t_pos - 1
            slot_valid[slot] = True
        if self._zero_slot is None or self._zero_slot.shape[1] != n_spatial:
            self._zero_slot = feats.new_zeros((1, n_spatial, md))
        mem_slots = [m if m is not None else self._zero_slot for m in mem_slots]
        pos_slots = [p if p is not None else self._zero_slot for p in pos_slots]

        # object pointers (`sam2_base.py:570-640`)
        max_ptrs = min(state["num_frames"], cfg.max_obj_ptrs_in_encoder)
        sign = -1 if reverse else 1
        pos_and_ptrs = [
            ((frame_idx - t) * sign if cfg.use_signed_tpos_enc_to_obj_ptrs
             else abs(frame_idx - t), out["obj_ptr"])
            for t, out in cond.items() if (t >= frame_idx if reverse else t <= frame_idx)]
        for t_diff in range(1, max_ptrs):
            t = frame_idx + t_diff if reverse else frame_idx - t_diff
            if t < 0 or t >= state["num_frames"]:
                break
            out = non_cond.get(t)
            if out is not None:
                pos_and_ptrs.append((t_diff, out["obj_ptr"]))
        pos_and_ptrs = pos_and_ptrs[:max_ptrs]
        k = len(pos_and_ptrs)
        ptr_list = [p for _, p in pos_and_ptrs]
        if self._zero_ptr is None or (ptr_list and self._zero_ptr.shape != ptr_list[0].shape):
            self._zero_ptr = (torch.zeros_like(ptr_list[0]) if ptr_list
                              else feats.new_zeros((cfg.d_model,)))
        ptr_list += [self._zero_ptr] * (max_ptrs - k)
        ptr_pos_norm = np.zeros(max_ptrs, np.float32)
        ptr_pos_norm[:k] = np.asarray([t for t, _ in pos_and_ptrs], np.float32) / max(
            max_ptrs - 1, 1)
        dev = feats.device
        low_res_masks, obj_ptr, obj_logits, mem_feats, mem_pos = self.model.propagate_step(
            feats, curr_pos, hi, tuple(mem_slots), tuple(pos_slots),
            torch.from_numpy(tpos_idx).to(dev), torch.from_numpy(slot_valid).to(dev),
            tuple(ptr_list), torch.from_numpy(ptr_pos_norm).to(dev), k,
            cfg.multimask_output_for_tracking)
        return {"maskmem_features": mem_feats, "maskmem_pos_enc": mem_pos,
                "pred_masks": low_res_masks[0], "obj_ptr": obj_ptr[0],
                "object_score_logits": obj_logits[0]}

    # ------------------------------------------------------------------
    def _run_single_frame(self, state: Dict, frame_idx: int, obj_id: int,
                          point_inputs: Optional[Dict]) -> Dict:
        """`sam2_base.py:808-907` for a frame without earlier memory (a
        conditioning frame): no-memory features, SAM heads, memory encoding."""
        cfg = self.cfg
        backbone = self._get_image_features(state, frame_idx)
        feats = backbone["backbone_fpn"][-1]       # (1, h, w, C)
        hi = high_res_features(backbone, cfg)
        B, h, w, C = feats.shape
        fused = self.model.no_memory_features(feats.reshape(B, h * w, C)).reshape(B, h, w, C)
        multimask = (cfg.multimask_output_in_sam if point_inputs is not None
                     else cfg.multimask_output_for_tracking)
        pts = None
        if point_inputs is not None:
            pts = {k: torch.from_numpy(np.asarray(v)).to(feats.device)
                   for k, v in point_inputs.items()}
        res = self.model.forward_sam_heads(fused, pts, None, hi, multimask)
        _, _, _, low_res_masks, high_res_masks, obj_ptr, obj_logits = res
        mem_feats, mem_pos = self.model.encode_new_memory(
            feats, high_res_masks.permute(0, 2, 3, 1), obj_logits)
        return {"maskmem_features": mem_feats, "maskmem_pos_enc": mem_pos,
                "pred_masks": low_res_masks[0], "obj_ptr": obj_ptr[0],
                "object_score_logits": obj_logits[0]}
