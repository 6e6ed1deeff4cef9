"""Datasets: annotation loading + per-sample pipelines.

Covers the reference's live dataset surface (SURVEY.md §2.2):
VideoDataset/MsrvttVideoDataset/MsvdVideoDataset (retrieval),
VideoQADataset/TGIF (QA), WebVid/CC3M (pretrain corpora), plus a synthetic
dataset that makes the full train loop runnable in CI with zero IO.

Annotation formats:
- txt lines:  "<path>\t<caption>" or "<path> <label>"
- jsonl:      one json object per line with keys filename/text/label/...
- pkl:        pickled list of dicts (reference PKLVideoDataset format)

A dataset returns numpy sample dicts; collation and device transfer live
in clover_tpu_torch.data.loader; device-side geometry in
clover_tpu_torch.ops.preprocess.

Port of ``clover_tpu/data/datasets.py``, copied. The frames' resize to the
canonical size is the port's ``canonical_host_resize`` (torch's bilinear
resize; the JAX package's is OpenCV's), within one uint8 level of the JAX
dataset's; every other key of a sample is bitwise the same.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from clover_tpu_torch.data.decode import get_backend
from clover_tpu_torch.data.sampling import sample_frame_indices
from clover_tpu_torch.data.text_masking import MASK_ENGINES
from clover_tpu_torch.data.tokenization import BertTokenizer, build_test_vocab
from clover_tpu_torch.data.video_masking import MaskingGenerator
from clover_tpu_torch.ops.preprocess import (
    canonical_host_resize,
    center_crop_params,
    random_resized_crop_params,
)


def load_annotations(ann_file: str) -> List[Dict[str, Any]]:
    if ann_file.endswith(".pkl"):
        with open(ann_file, "rb") as f:
            records = pickle.load(f)
        return list(records)
    records = []
    with open(ann_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if ann_file.endswith(".jsonl") or line.startswith("{"):
                records.append(json.loads(line))
            elif "\t" in line:
                path, text = line.split("\t", 1)
                records.append({"filename": path, "text": text})
            else:
                parts = line.rsplit(" ", 1)
                if len(parts) == 2 and parts[1].lstrip("-").isdigit():
                    records.append({"filename": parts[0], "label": int(parts[1])})
                else:
                    records.append({"filename": line})
    return records


class VideoTextDataset:
    """Video-text retrieval / pretraining dataset.

    Each record: {filename, text (str or list[str]), label?}. Train mode
    samples one caption per record (reference MsvdVideoDataset random
    caption choice, video_dataset.py:241-273); test mode expands to one
    entry per (video, caption) like MsrvttVideoDataset (:107-140).
    """

    def __init__(
        self,
        records: Optional[Sequence[Dict[str, Any]]] = None,
        ann_file: Optional[str] = None,
        data_prefix: str = "",
        tokenizer: Optional[BertTokenizer] = None,
        backend: str = "opencv",
        backend_kwargs: Optional[Dict] = None,
        num_frames: int = 8,
        canonical_size: int = 256,
        test_canonical_size: int = 224,
        max_length: int = 30,
        test_mode: bool = False,
        test_num_frames: Optional[int] = None,
        paragraph: bool = False,       # join list captions (DiDeMo temporal_cat)
        # pretrain extras
        mlm: bool = False,
        mask_engine: str = "content_word",
        mlm_probability: float = 0.15,
        video_mask: bool = False,
        video_mask_grid: int = 7,
        num_masking_patches: int = 10,
        min_video_num: int = 0,
        seed: int = 0,
    ):
        if records is None:
            records = load_annotations(ann_file)
        records = list(records)
        # oversample tiny datasets up to min_video_num (reference
        # VideoDataset min_video_num, video_dataset.py:14-104)
        if min_video_num and records and len(records) < min_video_num:
            reps = -(-min_video_num // len(records))
            records = (records * reps)[:min_video_num]
        self.records = records
        self.data_prefix = data_prefix
        self.tokenizer = tokenizer
        self.backend = get_backend(backend, **(backend_kwargs or {}))
        self.num_frames = num_frames
        self.test_num_frames = test_num_frames or num_frames
        self.canonical_size = canonical_size
        self.test_canonical_size = test_canonical_size
        self.max_length = max_length
        self.test_mode = test_mode
        self.paragraph = paragraph
        self.mlm = mlm
        self.mask_fn = MASK_ENGINES[mask_engine]
        self.mlm_probability = mlm_probability
        self.video_mask = video_mask
        self.seed = seed
        if video_mask:
            self.mask_generator = MaskingGenerator(
                (video_mask_grid, video_mask_grid), num_masking_patches)

        if test_mode:
            # expand (video, caption) pairs; remember per-video caption ids
            self.entries = []
            self.text_video_ids: List[List[int]] = []
            for vid, rec in enumerate(self.records):
                texts = rec.get("text", "")
                if self.paragraph and isinstance(texts, list):
                    texts = " ".join(texts)   # DiDeMo paragraph retrieval
                texts = [texts] if isinstance(texts, str) else list(texts)
                ids = []
                for text in texts:
                    ids.append(len(self.entries))
                    self.entries.append((vid, text))
                self.text_video_ids.append(ids)

    def __len__(self) -> int:
        return len(self.entries) if self.test_mode else len(self.records)

    def _decode_clip(self, path: str, n_frames: int, canonical: int,
                     rng: np.random.Generator, test: bool) -> np.ndarray:
        full = os.path.join(self.data_prefix, path)
        if getattr(self.backend, "layout", "thwc") == "s2d":
            # pre-s2d clip pack (clip_cache layout='s2d'): the record IS
            # the eval-ready clip — resize and the patch-embed transpose
            # were paid at pack-build time; per-clip cost is one memcpy.
            cache = self.backend.cache
            if not test:
                raise ValueError("s2d clip packs are eval-only (the s2d "
                                 "transform kills in-record frame sampling)")
            if (cache.frames != n_frames or cache.height != canonical
                    or cache.width != canonical):
                raise ValueError(
                    f"s2d pack holds {cache.frames}x{cache.height}x"
                    f"{cache.width} clips; dataset asked {n_frames}x"
                    f"{canonical}x{canonical}")
            return self.backend.decode(full, list(range(n_frames)))
        total = self.backend.num_frames(full)
        inds = sample_frame_indices(
            total, clip_len=1, num_clips=n_frames, test_mode=test, rng=rng)
        frames = self.backend.decode(full, inds)
        return canonical_host_resize(frames, canonical)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + idx) % (2 ** 31))
        if self.test_mode:
            vid, text = self.entries[idx]
            rec = self.records[vid]
            frames = self._decode_clip(
                rec["filename"], self.test_num_frames,
                self.test_canonical_size, rng, test=True)
            enc = self.tokenizer.encode(text, self.max_length)
            sample = {
                "imgs": frames[None],            # (1, T, S, S, 3)
                "index": np.int32(idx),
                "video_index": np.int32(vid),
                "crop_boxes": center_crop_params(
                    self.test_canonical_size, 224).astype(np.float32),
                "flip": np.bool_(False),
                **enc,
            }
            if "label" in rec:
                # zero-shot action eval consumes per-clip labels from the
                # batch (run_zeroshot_action_eval)
                sample["label"] = np.int32(rec["label"])
            return sample

        rec = self.records[idx]
        texts = rec.get("text", "")
        if self.paragraph and isinstance(texts, list):
            texts = " ".join(texts)
        text = texts if isinstance(texts, str) else texts[rng.integers(len(texts))]
        frames = self._decode_clip(
            rec["filename"], self.num_frames, self.canonical_size, rng, test=False)
        enc = self.tokenizer.encode(text, self.max_length)
        sample: Dict[str, np.ndarray] = {
            "imgs": frames[None],
            "crop_boxes": random_resized_crop_params(rng, self.canonical_size),
            "flip": np.bool_(rng.random() < 0.5),
            **enc,
        }
        if "label" in rec:
            sample["label"] = np.int32(rec["label"])
        if self.mlm:
            masked, mlm_label = self.mask_fn(
                sample["token_ids"], self.tokenizer, rng,
                mlm_probability=self.mlm_probability)
            sample["token_ids"] = masked
            sample["mlm_label"] = mlm_label.astype(np.int32)
        if self.video_mask:
            sample["v_token_mask"] = self.mask_generator(rng)
        return sample


class VideoQADataset:
    """Open-ended / multiple-choice video QA.

    Records: {filename, question, answer (str) | options (list) +
    answer_idx (int)}. OE mode maps answers into a label vocabulary;
    MC mode tokenizes each candidate "Q [SEP] option"
    (reference QATextPrepare / MCRetTextPrepare, loading.py:449-549).
    """

    def __init__(
        self,
        records: Optional[Sequence[Dict[str, Any]]] = None,
        ann_file: Optional[str] = None,
        data_prefix: str = "",
        tokenizer: Optional[BertTokenizer] = None,
        backend: str = "opencv",
        backend_kwargs: Optional[Dict] = None,
        num_frames: int = 8,
        canonical_size: int = 256,
        max_length: int = 40,
        test_mode: bool = False,
        mode: str = "oe",               # 'oe' | 'mc'
        answer_vocab: Optional[Dict[str, int]] = None,
        use_answer_mask: bool = False,  # append "the answer is [MASK]"
        seed: int = 0,
    ):
        if records is None:
            records = load_annotations(ann_file)
        self.records = list(records)
        self.data_prefix = data_prefix
        self.tokenizer = tokenizer
        self.backend = get_backend(backend, **(backend_kwargs or {}))
        self.num_frames = num_frames
        self.canonical_size = canonical_size
        self.max_length = max_length
        self.test_mode = test_mode
        self.mode = mode
        self.answer_vocab = answer_vocab
        self.use_answer_mask = use_answer_mask
        self.seed = seed

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed * 1_000_003 + idx) % (2 ** 31))
        rec = self.records[idx]
        full = os.path.join(self.data_prefix, rec["filename"])
        total = self.backend.num_frames(full)
        inds = sample_frame_indices(
            total, clip_len=1, num_clips=self.num_frames,
            test_mode=self.test_mode, rng=rng)
        frames = canonical_host_resize(
            self.backend.decode(full, inds), self.canonical_size)

        question = rec.get("question", "")
        if self.mode == "mc":
            # question-less MC (LSMDC-MC: candidates are captions, not QA
            # options — reference tokenizes each candidate alone,
            # loading.py:399-401) encodes the option as the only text
            encs = [
                (self.tokenizer.encode(question, self.max_length,
                                       second_text=opt)
                 if question else self.tokenizer.encode(opt, self.max_length))
                for opt in rec["options"]
            ]
            token_ids = np.stack([e["token_ids"] for e in encs])
            input_mask = np.stack([e["input_mask"] for e in encs])
            segment_ids = np.stack([e["segment_ids"] for e in encs])
            label = np.int32(rec["answer_idx"])
        else:
            text = question
            if self.use_answer_mask:
                text = question + " the answer is [MASK]"
                # encode, then swap the literal tokens for the mask id
            enc = self.tokenizer.encode(text, self.max_length)
            if self.use_answer_mask:
                ids = enc["token_ids"]
                # replace the token position of '[' (the literal bracket
                # sequence) with a true [MASK]: simpler — re-tokenize with
                # manual append
                enc = self.tokenizer.encode(question + " the answer is",
                                            self.max_length)
                ids = enc["token_ids"].copy()
                mask_vec = enc["input_mask"].copy()
                sep_pos = int(np.argmax(ids == self.tokenizer.sep_id))
                if sep_pos < self.max_length - 1:
                    ids[sep_pos] = self.tokenizer.mask_id
                    ids[sep_pos + 1] = self.tokenizer.sep_id
                    mask_vec[sep_pos + 1] = 1
                else:
                    ids[sep_pos - 1] = self.tokenizer.mask_id
                enc = {"token_ids": ids, "input_mask": mask_vec,
                       "segment_ids": enc["segment_ids"]}
            token_ids = enc["token_ids"][None]
            input_mask = enc["input_mask"][None]
            segment_ids = enc["segment_ids"][None]
            answer = rec.get("answer")
            if self.answer_vocab is not None and answer is not None:
                label = np.int32(self.answer_vocab.get(answer, 0))
            else:
                label = np.int32(rec.get("answer_idx", 0))

        crop = (center_crop_params(self.canonical_size, 224)
                if self.test_mode
                else random_resized_crop_params(rng, self.canonical_size))
        return {
            "imgs": frames[None],
            "token_ids": token_ids.astype(np.int32),
            "input_mask": input_mask.astype(np.int32),
            "segment_ids": segment_ids.astype(np.int32),
            "label": label,
            "index": np.int32(idx),
            "crop_boxes": crop.astype(np.float32),
            "flip": np.bool_(False if self.test_mode else rng.random() < 0.5),
        }


class ActionVideoDataset(VideoTextDataset):
    """Action recognition clips for zero-shot eval via class-name retrieval.

    Records: {filename, label} with 1-indexed labels (reference
    UCF101VideoDataset, video_dataset.py:443-513). Class-name embeddings
    are produced separately (`encode_class_names`) and passed to
    run_zeroshot_action_eval.
    """

    def __init__(self, records=None, ann_file=None, class_names=None, **kwargs):
        if records is None:
            records = load_annotations(ann_file)
        records = [{**rec, "text": ""} for rec in records]
        kwargs.setdefault("test_mode", True)
        super().__init__(records=records, **kwargs)
        self.class_names = list(class_names or [])

    def encode_class_names(self, template: str = "a video of {}"):
        encs = [
            self.tokenizer.encode(template.format(name), self.max_length)
            for name in self.class_names
        ]
        return {
            "token_ids": np.stack([e["token_ids"] for e in encs]),
            "input_mask": np.stack([e["input_mask"] for e in encs]),
        }


class MCRetrievalDataset(VideoTextDataset):
    """Multiple-choice-as-retrieval (MSRVTT-MC / LSMDC-MC).

    Records: {filename, options (list[str]), answer_idx}. Test entries are
    (video, option) pairs scored by the dual-tower retrieval model; the
    metric is multiple_choice_retrieval_acc (reference acc_for_msrvtt_mc,
    core/evaluation/accuracy.py:396-427, minus its debug dumps).

    ``test_mode=False`` trains: each video pairs with its CORRECT option
    as an ordinary retrieval positive (reference finetune_msrvtt_mc.py
    finetunes the retrieval towers with NormSoftmaxLoss on the MC train
    split; its dataset expands all 5 candidates but the loss's diagonal
    positive only makes sense for the answer caption — we pair the answer
    explicitly, which is the semantics that recipe converges to).
    """

    def __init__(self, records=None, ann_file=None, **kwargs):
        if records is None:
            records = load_annotations(ann_file)
        test_mode = kwargs.setdefault("test_mode", True)
        if test_mode:
            records = [
                {**rec, "text": list(rec["options"])} for rec in records
            ]
        else:
            # train mode pairs the CORRECT option — a missing answer_idx
            # would silently train on a distractor, so it is a hard error
            # here (at test time a missing key only mislabels the metric)
            for rec in records:
                if "answer_idx" not in rec:
                    raise KeyError(
                        "MCRetrievalDataset(test_mode=False) requires "
                        f"'answer_idx' on every record (missing for "
                        f"{rec.get('filename')!r})")
            records = [
                {**rec, "text": rec["options"][int(rec["answer_idx"])]}
                for rec in records
            ]
        super().__init__(records=records, **kwargs)
        self.labels = np.asarray(
            [rec.get("answer_idx", 0) for rec in self.records], np.int64)


_SYNTH_WORDS = (
    "a the person dog cat runs jumps sits eats red blue fast slow ball "
    "park street man woman child plays walks big small happy"
).split()


def make_synthetic_retrieval_dataset(
    n_videos: int = 16,
    captions_per_video: int = 1,
    test_mode: bool = False,
    num_frames: int = 4,
    canonical_size: int = 64,
    test_canonical_size: int = 64,
    max_length: int = 16,
    seed: int = 0,
    **kwargs,
) -> VideoTextDataset:
    """Zero-IO dataset for CI/benchmarks: synthetic frames + procedural
    captions over a small closed vocabulary."""
    rng = np.random.default_rng(seed)
    tokenizer = BertTokenizer(build_test_vocab(_SYNTH_WORDS))
    records = []
    for i in range(n_videos):
        texts = [
            " ".join(rng.choice(_SYNTH_WORDS, size=6))
            for _ in range(captions_per_video)
        ]
        records.append({"filename": f"synthetic_video_{i}.mp4",
                        "text": texts if captions_per_video > 1 else texts[0],
                        "label": i % 4})
    return VideoTextDataset(
        records=records,
        tokenizer=tokenizer,
        backend="synthetic",
        backend_kwargs={"height": 72, "width": 96},
        num_frames=num_frames,
        canonical_size=canonical_size,
        test_canonical_size=test_canonical_size,
        max_length=max_length,
        test_mode=test_mode,
        seed=seed,
        **kwargs,
    )
