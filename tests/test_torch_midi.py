"""The port's MIDI data against the JAX package's, exactly: the SMF writer
and reader (byte-equal files, equal notes), the piano-roll conversions
(equal uint8 images), the layout shuffles, the onset/sustain filter, the
augmentations, the chord colours, image → MIDI, ``calc_note_metrics`` (equal
floats and masks), the piano-roll transforms (equal arrays from equal
generators), ``MIDIImageDataset`` over a seeded corpus, the POP909 fetch
through a ``file://`` URL, and ``InpaintingDataset``'s items.
"""
import os
import zipfile

import numpy as np
import pytest
from PIL import Image

from flocoder_torch.data import datasets as tds
from flocoder_torch.data import midi_io as tmio
from flocoder_torch.data import pianoroll as tpr
from flocoder_torch.data import transforms as ttf
from flocoder_tpu.data import datasets as jds
from flocoder_tpu.data import midi_io as jmio
from flocoder_tpu.data import pianoroll as jpr
from flocoder_tpu.data import transforms as jtf


def _song(mio, seed=0):
    rng = np.random.default_rng(seed)
    insts = []
    for name, lo in (("MELODY", 60), ("PIANO", 36)):
        notes = [mio.MidiNote(pitch=int(rng.integers(lo, lo + 24)),
                              velocity=int(rng.integers(20, 127)),
                              start=round(i * 0.25, 4), end=round(i * 0.25 + 0.2, 4))
                 for i in range(24)]
        insts.append(mio.MidiInstrument(name=name, notes=notes))
    return mio.MidiFile(instruments=insts, tempos=[(0.0, 96.0)])


def test_midi_files_are_byte_equal_and_parse_alike(tmp_path):
    ours, ref = tmp_path / "t.mid", tmp_path / "j.mid"
    tmio.write_midi(str(ours), _song(tmio))
    jmio.write_midi(str(ref), _song(jmio))
    assert ours.read_bytes() == ref.read_bytes()
    a, b = tmio.read_midi(str(ref)), jmio.read_midi(str(ours))
    assert [i.name for i in a.instruments] == [i.name for i in b.instruments]
    for ia, ib in zip(a.instruments, b.instruments):
        assert [(n.pitch, n.velocity, n.start, n.end) for n in ia.notes] == \
            [(n.pitch, n.velocity, n.start, n.end) for n in ib.notes]
    assert a.get_tempo_changes()[1].tolist() == b.get_tempo_changes()[1].tolist()
    assert a.get_end_time() == b.get_end_time()


def test_synthetic_corpus_parses_and_rolls_to_squares(tmp_path):
    """The seeded corpus writer: each song parses back with both readers and
    every roll of it is a 128 × 128 image."""
    paths = tmio.write_synthetic_corpus(str(tmp_path / "c"), 3, seed=4)
    assert [os.path.relpath(p, tmp_path / "c") for p in paths] == \
        ["001/001.mid", "002/002.mid", "003/003.mid"]
    for p in paths:
        assert len(jmio.read_midi(p).instruments) == 2
        for f in tpr.midi_to_pr_img(p, str(tmp_path / "img")):
            assert Image.open(f).size == (128, 128)


def _imgs(paths):
    return [np.asarray(Image.open(p)) for p in paths]


def test_piano_roll_images_are_equal(tmp_path):
    src = tmp_path / "song.mid"
    tmio.write_midi(str(src), _song(tmio, 1))
    ours = tpr.midi_to_pr_img(str(src), str(tmp_path / "t"))
    ref = jpr.midi_to_pr_img(str(src), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    for a, b in zip(_imgs(ours), _imgs(ref)):
        assert a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    # chord bars from an annotation file
    (tmp_path / "song_chords.txt").write_text("0.0\t2.0\tC:maj\n2.0\t6.0\tA:min\n")
    chords = ["C:maj", "A:min"]
    ours = tpr.midi_to_pr_img(str(src), str(tmp_path / "tc"), show_chords=True,
                              all_chords=chords)
    ref = jpr.midi_to_pr_img(str(src), str(tmp_path / "jc"), show_chords=True,
                             all_chords=chords)
    for a, b in zip(_imgs(ours), _imgs(ref)):
        np.testing.assert_array_equal(a, b)
    for n in range(-1, 30):
        assert tpr.chord_num_to_color(n) == jpr.chord_num_to_color(n)
    for name in ("C:maj7", "A:min/5", "N", "G#:sus4(b7)"):
        assert tpr.simplify_chord(name) == jpr.simplify_chord(name)


def test_layouts_filter_augmentations_and_image_to_midi(tmp_path):
    rng = np.random.default_rng(2)
    arr = np.zeros((256, 256, 3), np.uint8)
    arr[rng.integers(0, 256, 300), rng.integers(0, 256, 300), 0] = 255
    for r in range(0, 256, 9):
        arr[r, 10:40, 1] = 200
        arr[r, 9, 0] = 255
    img = Image.fromarray(arr)
    for fn in ("square_to_rect", "rect_to_square", "regroup_lines"):
        np.testing.assert_array_equal(np.asarray(getattr(tpr, fn)(img)),
                                      np.asarray(getattr(jpr, fn)(img)))
    rect = tpr.square_to_rect(img)
    for onsets in (True, False):
        np.testing.assert_array_equal(np.asarray(tpr.filter_redgreen(rect, onsets)),
                                      np.asarray(jpr.filter_redgreen(rect, onsets)))
    a = tpr.RandomBarCrop()(rect, np.random.default_rng(5))
    b = jpr.RandomBarCrop()(rect, np.random.default_rng(5))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(tpr.stack_piano_rolls(rect)),
                                  np.asarray(jpr.stack_piano_rolls(rect)))
    img.save(tmp_path / "sq.png")
    ours = tpr.img_file_2_midi_file(tpr.square_to_rect_file(str(tmp_path / "sq.png")),
                                    str(tmp_path / "t.mid"))
    ref = jpr.img_file_2_midi_file(jpr.square_to_rect_file(str(tmp_path / "sq.png")),
                                   str(tmp_path / "j.mid"))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert sum(len(i.notes) for i in tmio.read_midi(ours).instruments) > 0


@pytest.mark.parametrize("keep_gray,channels", [(False, 3), (False, 1), (True, 1)])
def test_note_metrics_are_equal(keep_gray, channels):
    rng = np.random.default_rng(7)
    target = (rng.random((3, 32, 32, channels)) > 0.8).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.4, target.shape), 0, 1).astype(np.float32)
    ours, oimg = tpr.calc_note_metrics(pred, target, keep_gray=keep_gray, return_images=True)
    ref, rimg = jpr.calc_note_metrics(pred, target, keep_gray=keep_gray, return_images=True)
    assert ours == ref
    assert set(oimg) == set(rimg)
    for k in oimg:
        np.testing.assert_array_equal(oimg[k], rimg[k])


@pytest.mark.parametrize("kw", [{}, {"grayscale": True}, {"grayscale": True, "binary": True}])
def test_midi_transforms_draw_alike(kw):
    rng = np.random.default_rng(9)
    img = Image.fromarray(rng.integers(0, 256, (160, 200, 3), dtype=np.uint8))
    ours = ttf.midi_transforms(128, **kw)(img, np.random.default_rng(1))
    ref = jtf.midi_transforms(128, **kw)(img, np.random.default_rng(1))
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    arr = rng.random((24, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(ttf.random_roll(arr, np.random.default_rng(3)),
                                  jtf.random_roll(arr, np.random.default_rng(3)))
    np.testing.assert_array_equal(ttf.rgb_to_grayscale(arr), jtf.rgb_to_grayscale(arr))
    np.testing.assert_array_equal(ttf.binary_gate(arr), jtf.binary_gate(arr))


def test_midi_image_dataset_matches_jax(tmp_path):
    """A seeded corpus converted by both packages: the same PNGs, the same
    song-number split, the same items from the same generators, and the
    same loaders of ``create_image_loaders(is_midi=True)``."""
    tmio.write_synthetic_corpus(str(tmp_path / "midi"), 12, seed=1)
    for split, n in (("train", 33), ("val", 3)):
        ours = tds.MIDIImageDataset(str(tmp_path / "midi"), str(tmp_path / "ti"), split=split,
                                    transform=ttf.midi_transforms(64), num_workers=2)
        ref = jds.MIDIImageDataset(str(tmp_path / "midi"), str(tmp_path / "ji"), split=split,
                                   transform=jtf.midi_transforms(64), num_workers=2)
        assert len(ours) == len(ref) == n
        assert [os.path.relpath(f, tmp_path / "ti") for f in ours.files] == \
            [os.path.relpath(f, tmp_path / "ji") for f in ref.files]
        for i in (0, n - 1):
            (a, la), (b, lb) = (ours.get(i, np.random.default_rng(i)),
                                ref.get(i, np.random.default_rng(i)))
            np.testing.assert_array_equal(a, b)
            assert la == lb == 0
    ours = tds.create_image_loaders(8, 64, str(tmp_path / "midi"), num_workers=2, is_midi=True)
    ref = jds.create_image_loaders(8, 64, str(tmp_path / "midi"), num_workers=2, is_midi=True)
    for lo, lr in zip(ours, ref):
        assert len(lo) == len(lr)
        a, b = next(iter(lo)), next(iter(lr))
        np.testing.assert_array_equal(a["target"], b["target"])


def test_pop909_fetch_through_a_file_url(tmp_path):
    """``maybe_download_pop909`` and the download path of
    ``MIDIImageDataset`` driven by a ``file://`` URL: the zip is fetched
    and extracted, a second call reuses it, ``versions/`` takes are
    skipped. Nothing reaches the network."""
    src = tmp_path / "src"
    for rel in ("POP909/001/001.mid", "POP909/002/002.mid", "POP909/001/versions/alt.mid"):
        p = src / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        tmio.write_midi(str(p), _song(tmio))
    zip_path = tmp_path / "POP909.zip"
    with zipfile.ZipFile(zip_path, "w") as zf:
        for root, _, files in os.walk(src):
            for f in files:
                zf.write(os.path.join(root, f), os.path.relpath(os.path.join(root, f), src))
    url = "file://" + str(zip_path)
    got = tds.maybe_download_pop909(str(tmp_path / "corpus"), url=url)
    assert got == jds.maybe_download_pop909(str(tmp_path / "jcorpus"), url=url) \
        .replace("jcorpus", "corpus")
    assert tds.maybe_download_pop909(str(tmp_path / "corpus"), url=url) == got
    ds = tds.MIDIImageDataset(str(tmp_path / "corpus2"), image_dir=str(tmp_path / "imgs"),
                              split="train", url=url)
    assert len(ds) == 6
    assert tds.maybe_download_pop909(str(tmp_path / "c3"), url="file:///absent.zip") is None


def test_inpainting_dataset_items_match_jax():
    """Items of an image, a mask drawn from the item's generator, and the
    masked image, equal in both packages."""
    base_t = tds.SyntheticImageDataset(image_size=32)
    base_j = jds.SyntheticImageDataset(image_size=32, seed=0)
    ours, ref = tds.InpaintingDataset(base_t), jds.InpaintingDataset(base_j)
    assert len(ours) == len(ref)
    for i in range(6):
        (a, la), (b, lb) = ours.get(i, np.random.default_rng(i)), ref.get(i, np.random.default_rng(i))
        assert la == lb
        for k in ("target_latents", "source_latents", "mask_pixels"):
            np.testing.assert_array_equal(a[k], b[k])
