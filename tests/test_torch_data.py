"""The port's data pipeline (``clover_tpu_torch/data``) held against the
JAX package's (``clover_tpu/data``) on the CPU.

Every module is a copy, so every result must be bitwise the original's on
the same seeded numpy inputs, with one exception: the frames a dataset
resizes to its canonical size go through the port's
``canonical_host_resize`` (torch's bilinear resize; the JAX package's is
OpenCV's), so a sample's ``imgs`` may differ by one uint8 level (about 13%
of pixels do), and every other key is bitwise the same.
"""

import json
import pickle
import sys

import numpy as np
import pytest
import torch

from clover_tpu.data import clip_cache as jclip
from clover_tpu.data import datasets as jds
from clover_tpu.data import decode as jdecode
from clover_tpu.data import loader as jloader
from clover_tpu.data import sampling as jsampling
from clover_tpu.data import text_masking as jmasking
from clover_tpu.data import tokenization as jtok
from clover_tpu.data import video_masking as jvmask
from clover_tpu_torch.data import clip_cache as pclip
from clover_tpu_torch.data import datasets as pds
from clover_tpu_torch.data import decode as pdecode
from clover_tpu_torch.data import loader as ploader
from clover_tpu_torch.data import sampling as psampling
from clover_tpu_torch.data import text_masking as pmasking
from clover_tpu_torch.data import tokenization as ptok
from clover_tpu_torch.data import video_masking as pvmask

WORDS = ("a the person dog cat runs jumps sits eats red blue fast slow ball park street "
         "man woman child plays walks big small happy").split()


def assert_samples_equal(got, want, what=""):
    """Every key bitwise equal, but ``imgs`` within one uint8 level."""
    assert got.keys() == want.keys(), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        if k == "imgs":
            assert np.abs(g.astype(np.int16) - w.astype(np.int16)).max() <= 1, (what, k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("total,clip_len,interval,num_clips,test_mode,twice", [
    (64, 1, 1, 8, False, False), (64, 1, 1, 8, True, False), (5, 1, 1, 8, False, False),
    (5, 1, 1, 8, True, False), (100, 2, 3, 4, False, False), (100, 2, 3, 4, True, True),
    (1, 1, 1, 4, False, False)])
def test_sampling_matches_jax(total, clip_len, interval, num_clips, test_mode, twice):
    for seed in range(3):
        kw = dict(clip_len=clip_len, frame_interval=interval, num_clips=num_clips,
                  test_mode=test_mode, twice_sample=twice)
        got = psampling.sample_frame_indices(total, rng=np.random.default_rng(seed), **kw)
        want = jsampling.sample_frame_indices(total, rng=np.random.default_rng(seed), **kw)
        np.testing.assert_array_equal(got, want)


TEXTS = [
    "A dog runs in the park!",
    "Ça va? naïve café, résumé -- Über straße",
    "一个男人在弹吉他 and 日本語のテキスト",
    "punctuation: (a) [b] {c}; 'quoted' \"double\" ... #hash @at $5.00 50%",
    " ".join(WORDS * 6) + " supercalifragilistic antidisestablishmentarianism",
    "\t tabs\nnewlines\r\n and   spaces ​ zero-width   nbsp",
    "",
]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_matches_jax(text):
    vocab = jtok.build_test_vocab(WORDS + ["ça", "café", "##é", "日", "吉"])
    assert ptok.build_test_vocab(WORDS + ["ça", "café", "##é", "日", "吉"]) == vocab
    p, j = ptok.BertTokenizer(dict(vocab)), jtok.BertTokenizer(dict(vocab))
    assert p.tokenize(text) == j.tokenize(text)
    assert ptok.basic_tokenize(text) == jtok.basic_tokenize(text)
    for max_length in (8, 30):
        for second in (None, "the dog sits"):
            got, want = p.encode(text, max_length, second), j.encode(text, max_length, second)
            assert_samples_equal(got, want, text)
    ids = j.encode(text, 30)["token_ids"]
    assert p.decode(ids) == j.decode(ids)


@pytest.mark.parametrize("engine", sorted(jmasking.MASK_ENGINES))
def test_mask_engines_match_jax(engine):
    assert sorted(pmasking.MASK_ENGINES) == sorted(jmasking.MASK_ENGINES)
    vocab = jtok.build_test_vocab(WORDS)
    p, j = ptok.BertTokenizer(dict(vocab)), jtok.BertTokenizer(dict(vocab))
    captions = ["a man plays ball in the park", "the happy dog runs fast",
                "a small child walks and a big cat sits", "red blue", "a the"]
    for seed, text in enumerate(captions * 2):
        ids = j.encode(text, 20)["token_ids"]
        for prob in (0.15, 0.5):
            got = pmasking.MASK_ENGINES[engine](ids, p, np.random.default_rng(seed),
                                               mlm_probability=prob)
            want = jmasking.MASK_ENGINES[engine](ids, j, np.random.default_rng(seed),
                                                mlm_probability=prob)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cls,kw", [
    ("MaskingGenerator", dict(input_size=(7, 7), num_masking_patches=10)),
    ("MaskingGenerator", dict(input_size=(4, 4), num_masking_patches=4, min_num_patches=2)),
    ("RandomMaskGenerator", dict(input_size=(7, 7), num_masking_patches=10)),
])
def test_video_mask_generators_match_jax(cls, kw):
    p, j = getattr(pvmask, cls)(**kw), getattr(jvmask, cls)(**kw)
    for seed in range(8):
        np.testing.assert_array_equal(p(np.random.default_rng(seed)),
                                      j(np.random.default_rng(seed)))


def test_synthetic_backend_is_bitwise():
    p, j = pdecode.get_backend("synthetic", height=40, width=56), \
        jdecode.get_backend("synthetic", height=40, width=56)
    for path in ("a.mp4", "synthetic_video_3.mp4", "dir/x.avi"):
        assert p.num_frames(path) == j.num_frames(path)
        np.testing.assert_array_equal(p.decode(path, [0, 5, 63, 5]), j.decode(path, [0, 5, 63, 5]))


def test_decode_backends_without_opencv_and_ffmpeg(monkeypatch, tmp_path):
    """The cv2 backends import OpenCV when they first decode and raise
    ImportError naming it where it is missing; 'ffmpeg' is not a backend of
    the port (its native decoder is not ported)."""
    with pytest.raises(ValueError, match="unknown decode backend 'ffmpeg'"):
        pdecode.get_backend("ffmpeg")
    monkeypatch.setitem(sys.modules, "cv2", None)
    for name in ("opencv", "image", "rawframes"):
        backend = pdecode.get_backend(name)
        with pytest.raises(ImportError, match="cv2"):
            backend.decode(str(tmp_path / "x"), [0])


@pytest.mark.parametrize("layout", ["thwc", "s2d"])
def test_clip_cache_round_trip_matches_jax(tmp_path, layout):
    """A pack written by either package's writer reads back bitwise by both
    readers and through the 'packed' backend, in both layouts."""
    rng = np.random.default_rng(0)
    clips = {f"v/{i}.mp4": rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
             for i in range(3)}
    patch = (2, 4, 4) if layout == "s2d" else None
    for writer, name in ((pclip.ClipCacheWriter, "p"), (jclip.ClipCacheWriter, "j")):
        with writer(str(tmp_path / name), 4, 16, 16, layout=layout, patch=patch) as w:
            for k, c in clips.items():
                w.append(k, c)
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())
    pc, jc = pclip.ClipCache(str(tmp_path / "j")), jclip.ClipCache(str(tmp_path / "p"))
    assert pc.record_shape == jc.record_shape and pc.keys == jc.keys
    backend = pdecode.get_backend("packed", path=str(tmp_path / "p.json"))
    for i, k in enumerate(clips):
        np.testing.assert_array_equal(pc.get(k), jc.get(i, copy=True))
        inds = list(range(4))
        np.testing.assert_array_equal(backend.decode("/data/" + k, inds), jc.get(k, inds))
    if layout == "thwc":
        np.testing.assert_array_equal(pc.get(0, [3, 1]), jc.get(0, [3, 1]))
    else:
        with pytest.raises(ValueError, match="s2d-layout"):
            pc.get(0, [1, 0, 2, 3])
    assert pickle.loads(pickle.dumps(pc)).get(1).tobytes() == pc.get(1).tobytes()


def _records(n=6):
    return [{"filename": f"synthetic_video_{i}.mp4",
             "text": [f"a dog runs {i}", "the cat sits"] if i % 2 else "a man plays ball",
             "label": i % 3} for i in range(n)]


def _qa_records(n=6):
    return [{"filename": f"synthetic_video_{i}.mp4", "question": "what does the dog do",
             "answer": ["runs", "sits", "eats"][i % 3], "answer_idx": i % 3,
             "options": ["the dog runs", "a cat sits", "a man eats"]} for i in range(n)]


DATASETS = {
    "text-train": ("VideoTextDataset", dict(records=_records(), num_frames=4,
                                            canonical_size=40)),
    "text-test": ("VideoTextDataset", dict(records=_records(), num_frames=4,
                                           test_canonical_size=36, test_mode=True,
                                           test_num_frames=6)),
    "text-paragraph-mlm": ("VideoTextDataset", dict(
        records=_records(), num_frames=4, canonical_size=40, paragraph=True, mlm=True,
        mask_engine="whole_word", video_mask=True, video_mask_grid=4,
        num_masking_patches=4, min_video_num=9, seed=3)),
    "qa-oe": ("VideoQADataset", dict(records=_qa_records(), num_frames=4, canonical_size=40,
                                      answer_vocab={"runs": 1, "sits": 2})),
    "qa-oe-mask": ("VideoQADataset", dict(records=_qa_records(), num_frames=4,
                                           canonical_size=40, use_answer_mask=True,
                                           test_mode=True, max_length=12)),
    "qa-mc": ("VideoQADataset", dict(records=_qa_records(), num_frames=4, canonical_size=40,
                                      mode="mc")),
    "action": ("ActionVideoDataset", dict(records=_records(), num_frames=4,
                                          test_canonical_size=36,
                                          class_names=["run", "sit", "eat"])),
    "mc-test": ("MCRetrievalDataset", dict(records=_qa_records(), num_frames=4,
                                           test_canonical_size=36)),
    "mc-train": ("MCRetrievalDataset", dict(records=_qa_records(), num_frames=4,
                                            canonical_size=40, test_mode=False)),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_datasets_match_jax(name):
    cls, kw = DATASETS[name]
    vocab = jtok.build_test_vocab(WORDS + ["what", "does", "do"])
    common = dict(backend="synthetic", backend_kwargs=dict(height=30, width=44))
    p = getattr(pds, cls)(tokenizer=ptok.BertTokenizer(dict(vocab)), **common, **kw)
    j = getattr(jds, cls)(tokenizer=jtok.BertTokenizer(dict(vocab)), **common, **kw)
    assert len(p) == len(j) > 0
    for attr in ("text_video_ids", "labels"):
        if hasattr(j, attr):
            assert np.array_equal(np.asarray(getattr(p, attr), dtype=object),
                                  np.asarray(getattr(j, attr), dtype=object))
    for i in range(len(j)):
        assert_samples_equal(p[i], j[i], f"{name}[{i}]")
    if cls == "ActionVideoDataset":
        assert_samples_equal(p.encode_class_names(), j.encode_class_names())


@pytest.mark.parametrize("kw", [dict(), dict(test_mode=True, captions_per_video=2),
                                dict(mlm=True, video_mask=True, video_mask_grid=4,
                                     num_masking_patches=4, mask_engine="pos_content_word")])
def test_synthetic_retrieval_dataset_matches_jax(kw):
    p = pds.make_synthetic_retrieval_dataset(n_videos=5, num_frames=4, canonical_size=40,
                                             test_canonical_size=40, seed=2, **kw)
    j = jds.make_synthetic_retrieval_dataset(n_videos=5, num_frames=4, canonical_size=40,
                                             test_canonical_size=40, seed=2, **kw)
    assert p.records == j.records and p.tokenizer.vocab == j.tokenizer.vocab
    for i in range(len(j)):
        assert_samples_equal(p[i], j[i], f"{kw}[{i}]")


def test_load_annotations_matches_jax(tmp_path):
    files = {
        "a.txt": "v/0.mp4\ta dog runs\nv/1.mp4\tthe cat sits\n\n",
        "b.txt": "v/0.mp4 3\nv/1.mp4 -1\nv/2 name.mp4\n",
        "c.jsonl": '{"filename": "v/0.mp4", "text": ["x", "y"]}\n{"filename": "v/1.mp4"}\n',
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    with open(tmp_path / "d.pkl", "wb") as f:
        pickle.dump(_records(3), f)
    for name in list(files) + ["d.pkl"]:
        path = str(tmp_path / name)
        assert pds.load_annotations(path) == jds.load_annotations(path)
    ds = pds.VideoTextDataset(ann_file=str(tmp_path / "a.txt"), backend="synthetic",
                              tokenizer=ptok.BertTokenizer(ptok.build_test_vocab(WORDS)))
    assert [r["text"] for r in ds.records] == ["a dog runs", "the cat sits"]


@pytest.mark.parametrize("n,rank,world,seed,epoch,shuffle,drop_last,batch", [
    (10, 0, 1, 0, 0, True, False, 1), (10, 1, 3, 5, 2, True, False, 2),
    (17, 2, 4, 1, 7, True, True, 3), (17, 0, 2, 0, 0, False, False, 4),
    (8, 3, 4, 9, 1000, True, True, 1)])
def test_samplers_match_jax(n, rank, world, seed, epoch, shuffle, drop_last, batch):
    kw = dict(rank=rank, world_size=world, seed=seed, drop_last=drop_last, batch_size=batch)
    np.testing.assert_array_equal(
        ploader.ShardedSampler(n, shuffle=shuffle, **kw).indices(epoch),
        jloader.ShardedSampler(n, shuffle=shuffle, **kw).indices(epoch))
    labels = [i % 3 for i in range(n)]
    probs = {0: 2.0, 2: 0.5}
    np.testing.assert_array_equal(
        ploader.ClassBalancedSampler(labels, probs, **kw).indices(epoch),
        jloader.ClassBalancedSampler(labels, probs, **kw).indices(epoch))


def _synthetic(mod, test_mode=False):
    return mod.make_synthetic_retrieval_dataset(n_videos=10, num_frames=4, canonical_size=32,
                                                test_canonical_size=32, test_mode=test_mode)


def _epoch(loader, epoch):
    return [{k: np.array(v) for k, v in b.items()} for b in loader.epoch(epoch)]


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_samples_equal(g, w)


@pytest.mark.parametrize("test_mode", [False, True])
def test_loader_batches_match_across_workers_and_jax(test_mode):
    """Thread workers (1 and 3) give the same batches, and the JAX loader's
    (imgs within one level); with ``reuse_buffers`` too, copied at once."""
    kw = dict(batch_size=4, shuffle=not test_mode, drop_last=not test_mode, seed=3)
    ds = _synthetic(pds, test_mode)
    one = ploader.DataLoader(ds, num_workers=1, **kw)
    assert len(one) == len(jloader.DataLoader(_synthetic(jds, test_mode), **kw))
    for epoch in (0, 1):
        ref = _epoch(one, epoch)
        _assert_batches_equal(_epoch(ploader.DataLoader(ds, num_workers=3, **kw), epoch), ref)
        _assert_batches_equal(
            _epoch(ploader.DataLoader(ds, num_workers=3, reuse_buffers=5, **kw), epoch), ref)
        _assert_batches_equal(
            ref, _epoch(jloader.DataLoader(_synthetic(jds, test_mode), num_workers=2, **kw),
                        epoch))


def test_loader_spawn_process_workers_match_threads():
    ds = _synthetic(pds)
    kw = dict(batch_size=4, seed=1)
    loader = ploader.DataLoader(ds, num_workers=2, worker_type="process", **kw)
    try:
        got = _epoch(loader, 1)
    finally:
        loader.close()
    _assert_batches_equal(got, _epoch(ploader.DataLoader(ds, num_workers=2, **kw), 1))


def test_pooled_collate_keeps_same_shaped_arrays_apart():
    """The port's buffer ring is per batch key: a batch's three (B, L) int32
    arrays (token_ids, input_mask, segment_ids) keep their own rings, so a
    batch stays intact until ``depth`` more batches have been collated. The
    JAX pool shares one ring among them and overwrites the first batch's
    token_ids by the second batch at depth 5 (a fault of the reference,
    ROADMAP.md Queue 3)."""
    ds = _synthetic(pds)
    samples = [[ds[i] for i in range(b, b + 2)] for b in (0, 2)]
    ref = [ploader.default_collate(s) for s in samples]
    pcollate, jcollate = ploader.make_pooled_collate(5), jloader.make_pooled_collate(5)
    got = [pcollate(s) for s in samples]
    _assert_batches_equal(got, ref)
    jgot = [jcollate(s) for s in samples]
    assert not np.array_equal(jgot[0]["token_ids"], ref[0]["token_ids"])


def test_reuse_buffers_needs_room_for_the_pipeline():
    with pytest.raises(ValueError, match="must exceed prefetch"):
        ploader.DataLoader(_synthetic(pds), batch_size=2, prefetch=2, reuse_buffers=4)


@pytest.mark.parametrize("patch", [(2, 4, 4), (1, 2, 2)])
def test_s2d_collate_matches_jax(patch):
    ds = _synthetic(pds, test_mode=True)
    samples = [ds[i] for i in range(3)]
    got = ploader.make_s2d_collate(patch)(samples)
    want = jloader.make_s2d_collate(patch)(samples)
    assert_samples_equal(got, want)
    assert got["imgs"].shape[-1] == 3 * int(np.prod(patch))
    # samples already in the s2d layout pass through
    again = ploader.make_s2d_collate(patch)([{"imgs": got["imgs"][0]}])
    np.testing.assert_array_equal(again["imgs"][0], got["imgs"][0])
    loader = ploader.DataLoader(ds, batch_size=3, shuffle=False, drop_last=False,
                                host_s2d=patch, num_workers=1)
    np.testing.assert_array_equal(next(iter(loader))["imgs"], got["imgs"])


def test_prefetch_to_device_on_the_cpu_is_a_plain_generator():
    """On the CPU the batches come out as tensors, copies of the loader's
    arrays: ten batches through a ring of five recycled buffers, all kept,
    still equal the loader's batches without recycling."""
    ds = _synthetic(pds)
    loader = ploader.DataLoader(ds, batch_size=1, num_workers=2, reuse_buffers=5)
    ref = _epoch(ploader.DataLoader(ds, batch_size=1, num_workers=1), 0)
    got = list(ploader.prefetch_to_device(loader.epoch(0), device="cpu", size=2))
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])
