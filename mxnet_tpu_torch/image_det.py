"""Detection data pipeline: label-aware augmenters + ImageDetRecordIter
(port of ``mxnet_tpu/image_det.py``, the same code; batches land on the
context current at construction, copied as ``ImageRecordIter`` copies).

Capability port of the reference's detection IO stack
(src/io/iter_image_det_recordio.cc:563 + image_det_aug_default.cc): records
are packed by tools/im2rec.py with a flat detection label
``[header_width, object_width, (id, xmin, ymin, xmax, ymax, ...) * N]``
(coords normalized to [0, 1]); the iterator emits

- data:  (batch, C, H, W) float32
- label: (batch, label_pad_width + 4) where each row is filled with
  ``label_pad_value`` and carries ``[channels, rows, cols, label_len,
  *flat_label]`` (iter_image_det_recordio.cc:436-444)

Augmenters transform image AND boxes together (random IOU-constrained
crop, random expand/pad, horizontal mirror, forced resize — the core of
image_det_aug_default.cc's sampler set).
"""
from __future__ import annotations

import logging
import random as pyrandom

import numpy as np

from .base import MXNetError
from . import io as mxio
from . import recordio
from .context import current_context
from .image import (ImageRecordIter, _upload_batch, color_normalize,
                    imdecode, imresize)
from .io import DataDesc

__all__ = ["DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "DetForceResizeAug", "CreateDetAugmenter", "ImageDetRecordIter"]


class _DetLabel(object):
    """Parsed detection label: header + (N, object_width) objects with
    columns [id, xmin, ymin, xmax, ymax, extra...]."""

    def __init__(self, flat):
        flat = np.asarray(flat, dtype=np.float32)
        if flat.size < 2:
            raise MXNetError("detection label too short: %r" % (flat,))
        self.header_width = int(flat[0])
        self.object_width = int(flat[1])
        if self.header_width < 2 or self.object_width < 5:
            raise MXNetError(
                "bad detection label header (header_width=%d, "
                "object_width=%d); expected [header_width, object_width, "
                "id x1 y1 x2 y2 ...]" % (self.header_width,
                                         self.object_width))
        self.header = flat[:self.header_width]
        body = flat[self.header_width:]
        n = body.size // self.object_width
        self.objects = body[:n * self.object_width].reshape(
            n, self.object_width).copy()

    def flat(self):
        return np.concatenate([self.header, self.objects.reshape(-1)])


def _overlap_1d(a0, a1, b0, b1):
    return max(0.0, min(a1, b1) - max(a0, b0))


def _iou(box, crop):
    inter = _overlap_1d(box[0], box[2], crop[0], crop[2]) * \
        _overlap_1d(box[1], box[3], crop[1], crop[3])
    if inter <= 0:
        return 0.0
    area_a = (box[2] - box[0]) * (box[3] - box[1])
    area_b = (crop[2] - crop[0]) * (crop[3] - crop[1])
    return inter / (area_a + area_b - inter)


def DetHorizontalFlipAug(p):
    """Mirror image and boxes together (image_det_aug_default.cc
    rand_mirror_prob)."""
    def aug(src, label):
        if pyrandom.random() < p:
            src = src[:, ::-1]
            boxes = label.objects
            xmin = boxes[:, 1].copy()
            boxes[:, 1] = 1.0 - boxes[:, 3]
            boxes[:, 3] = 1.0 - xmin
        return src, label
    return aug


def DetRandomCropAug(min_scale=0.3, max_scale=1.0, min_aspect=0.5,
                     max_aspect=2.0, min_overlap=0.1, max_trials=25,
                     prob=0.5):
    """IOU-constrained random crop (the reference's crop sampler,
    image_det_aug_default.cc min_crop_scales/min_crop_overlaps): sample a
    crop window whose IOU with at least one ground-truth box exceeds
    ``min_overlap``; objects whose center falls outside are dropped, the
    rest are clipped and re-normalized to the crop."""
    def aug(src, label):
        if pyrandom.random() >= prob or len(label.objects) == 0:
            return src, label
        h, w = src.shape[:2]
        for _ in range(max_trials):
            scale = pyrandom.uniform(min_scale, max_scale)
            ratio = pyrandom.uniform(min_aspect, max_aspect)
            cw = min(1.0, scale * np.sqrt(ratio))
            ch = min(1.0, scale / np.sqrt(ratio))
            cx = pyrandom.uniform(0, 1 - cw)
            cy = pyrandom.uniform(0, 1 - ch)
            crop = (cx, cy, cx + cw, cy + ch)
            ious = [_iou(b[1:5], crop) for b in label.objects]
            if max(ious) < min_overlap:
                continue
            # keep objects whose center is inside the crop
            kept = []
            for b in label.objects:
                ctr_x = (b[1] + b[3]) / 2
                ctr_y = (b[2] + b[4]) / 2
                if not (crop[0] <= ctr_x <= crop[2]
                        and crop[1] <= ctr_y <= crop[3]):
                    continue
                nb = b.copy()
                nb[1] = (min(max(b[1], crop[0]), crop[2]) - cx) / cw
                nb[2] = (min(max(b[2], crop[1]), crop[3]) - cy) / ch
                nb[3] = (min(max(b[3], crop[0]), crop[2]) - cx) / cw
                nb[4] = (min(max(b[4], crop[1]), crop[3]) - cy) / ch
                kept.append(nb)
            if not kept:
                continue
            x0, y0 = int(cx * w), int(cy * h)
            x1, y1 = int((cx + cw) * w), int((cy + ch) * h)
            src = src[y0:max(y1, y0 + 1), x0:max(x1, x0 + 1)]
            label.objects = np.asarray(kept, dtype=np.float32)
            return src, label
        return src, label
    return aug


def DetRandomPadAug(max_scale=2.0, fill_value=127, prob=0.5):
    """Random expand: place the image on a larger canvas and shrink the
    boxes accordingly (image_det_aug_default.cc rand_pad_prob /
    max_pad_scale) — the standard SSD small-object augmentation."""
    def aug(src, label):
        if pyrandom.random() >= prob or max_scale <= 1.0:
            return src, label
        h, w = src.shape[:2]
        scale = pyrandom.uniform(1.0, max_scale)
        nh, nw = int(h * scale), int(w * scale)
        y0 = pyrandom.randint(0, nh - h)
        x0 = pyrandom.randint(0, nw - w)
        canvas = np.full((nh, nw, src.shape[2]), fill_value, dtype=src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        boxes = label.objects
        boxes[:, 1] = (boxes[:, 1] * w + x0) / nw
        boxes[:, 3] = (boxes[:, 3] * w + x0) / nw
        boxes[:, 2] = (boxes[:, 2] * h + y0) / nh
        boxes[:, 4] = (boxes[:, 4] * h + y0) / nh
        return canvas, label
    return aug


def DetForceResizeAug(size, interp=1):
    """Force resize to (w, h); normalized boxes are unchanged
    (resize_mode='force', image_det_aug_default.cc)."""
    def aug(src, label):
        return imresize(src, size[0], size[1], interp), label
    return aug


def CreateDetAugmenter(data_shape, resize=0, rand_crop_prob=0,
                       min_crop_scales=0.3, max_crop_scales=1.0,
                       min_crop_overlaps=0.1, max_crop_trials=25,
                       rand_pad_prob=0, max_pad_scale=2.0,
                       rand_mirror_prob=0, fill_value=127, inter_method=1,
                       mean=None, std=None):
    """Standard detection augmenter list (the reference's
    ListDefaultDetAugParams surface, simplified to one crop sampler)."""
    auglist = []
    if rand_crop_prob > 0:
        auglist.append(DetRandomCropAug(
            min_scale=min_crop_scales, max_scale=max_crop_scales,
            min_overlap=min_crop_overlaps, max_trials=max_crop_trials,
            prob=rand_crop_prob))
    if rand_pad_prob > 0:
        auglist.append(DetRandomPadAug(max_scale=max_pad_scale,
                                       fill_value=fill_value,
                                       prob=rand_pad_prob))
    if rand_mirror_prob > 0:
        auglist.append(DetHorizontalFlipAug(rand_mirror_prob))
    # detection always force-resizes to the network input
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    if mean is not None or std is not None:
        def norm_aug(src, label, _m=mean, _s=std):
            return color_normalize(src, _m, _s), label
        auglist.append(norm_aug)
    return auglist


class ImageDetRecordIter(mxio.DataIter):
    """RecordIO detection iterator (reference
    iter_image_det_recordio.cc:ImageDetRecordIter).

    Reads im2rec-packed records whose header label is the flat detection
    format; applies the label-aware augmenter chain; emits padded labels
    ``(batch, label_pad_width + 4)`` with the [channels, rows, cols, len]
    prologue, exactly like the reference parser.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, label_pad_width=0, label_pad_value=-1.0,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=0.0, std_g=0.0, std_b=0.0,
                 data_name="data", label_name="label", verbose=False,
                 ctx=None, **aug_kwargs):
        super().__init__(batch_size)
        from .dataflow import Uploader
        self._ctx = ctx if ctx is not None else current_context()
        self._uploader = Uploader(self._ctx.torch_device)
        self.data_shape = tuple(data_shape)
        self.label_pad_value = float(label_pad_value)
        self.data_name = data_name
        self.label_name = label_name
        if path_imgidx:
            self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec,
                                                   "r")
            self._keys = list(self._rec.keys)
        else:
            self._rec = recordio.MXRecordIO(path_imgrec, "r")
            self._keys = None
            if shuffle:
                logging.warning(
                    "ImageDetRecordIter: shuffle requires path_imgidx (the "
                    "stream reader is sequential); iterating in file order")
        self.shuffle = shuffle
        self._stream_part = None
        if num_parts > 1:
            if self._keys is not None:
                chunk = len(self._keys) // num_parts
                self._keys = self._keys[part_index * chunk:
                                        (part_index + 1) * chunk]
            else:
                # shard the sequential stream by record position
                self._stream_part = (part_index, num_parts)
        mean = [mean_r, mean_g, mean_b] if any([mean_r, mean_g, mean_b]) \
            else None
        std = [std_r, std_g, std_b] if any([std_r, std_g, std_b]) else None
        if aug_list is None:
            aug_list = CreateDetAugmenter(self.data_shape, mean=mean,
                                          std=std, **aug_kwargs)
        self.auglist = aug_list

        # estimate the label padding width over the whole file, like the
        # reference's pre-scan (iter_image_det_recordio.cc:269-316)
        max_width = self._scan_max_label_width()
        if max_width > label_pad_width:
            if label_pad_width > 0:
                raise MXNetError(
                    "ImageDetRecordIter: label_pad_width %d smaller than "
                    "estimated width %d" % (label_pad_width, max_width))
            label_pad_width = max_width
        self.label_pad_width = label_pad_width
        if verbose:
            logging.info("ImageDetRecordIter: %s, label padding width: %d",
                         path_imgrec, label_pad_width)
        self._cursor = 0
        self.reset()

    def _scan_max_label_width(self):
        width = 0
        self._rec.reset()
        while True:
            s = self._rec.read()
            if s is None:
                break
            header, _ = recordio.unpack(s)
            label = np.asarray(header.label)
            if label.ndim == 0 or label.size < 2:
                raise MXNetError("record without a detection label")
            width = max(width, label.size)
        self._rec.reset()
        return int(width)

    @property
    def provide_data(self):
        return [DataDesc(self.data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.label_pad_width + 4))]

    def reset(self):
        if self._keys is not None and self.shuffle:
            pyrandom.shuffle(self._keys)
        self._cursor = 0
        self._rec.reset()

    def _next_record(self):
        if self._keys is not None:
            if self._cursor >= len(self._keys):
                return None
            s = self._rec.read_idx(self._keys[self._cursor])
            self._cursor += 1
            return s
        while True:
            s = self._rec.read()
            if s is None or self._stream_part is None:
                return s
            part, nparts = self._stream_part
            pos = self._cursor
            self._cursor += 1
            if pos % nparts == part:
                return s

    def next(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), dtype=np.float32)
        labels = np.full((self.batch_size, self.label_pad_width + 4),
                         self.label_pad_value, dtype=np.float32)
        n = 0
        while n < self.batch_size:
            s = self._next_record()
            if s is None:
                break
            header, img = recordio.unpack(s)
            try:
                arr = imdecode(img)
            except (RuntimeError, MXNetError) as e:
                logging.debug("Invalid image, skipping: %s", str(e))
                continue
            label = _DetLabel(np.asarray(header.label))
            for aug in self.auglist:
                arr, label = aug(arr, label)
            flat = label.flat()
            if flat.size > self.label_pad_width:
                raise MXNetError(
                    "augmented label width %d exceeds label_pad_width %d "
                    "(an augmenter added boxes?); construct the iterator "
                    "with an explicit larger label_pad_width"
                    % (flat.size, self.label_pad_width))
            data[n] = np.asarray(arr, dtype=np.float32).transpose(2, 0, 1)
            labels[n, 0] = arr.shape[2] if arr.ndim == 3 else 1
            labels[n, 1] = arr.shape[0]
            labels[n, 2] = arr.shape[1]
            labels[n, 3] = flat.size
            labels[n, 4:4 + flat.size] = flat
            n += 1
        if n == 0:
            raise StopIteration
        batch = _upload_batch(self._ctx, self._uploader, data, labels,
                              self.batch_size - n)
        batch.provide_data = self.provide_data
        batch.provide_label = self.provide_label
        return ImageRecordIter._ready(batch)
