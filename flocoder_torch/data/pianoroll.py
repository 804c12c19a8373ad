"""MIDI ⇄ piano-roll image conversion, the port's own copy of
``flocoder_tpu/data/pianoroll.py`` (numpy + PIL, on the port's
``data/midi_io.py``):

- MIDI → image: tempo-normalised sampling fs = 8·bps, per-instrument rolls
  (MELODY/PIANO/TOTAL) with velocity-valued pixels and 1-px note gaps, an
  RGB render with green = sustain and red onset markers; chord-colour bars
  from POP909 ``*_chords.txt`` annotations;
- image → MIDI: the ``filter_redgreen`` onset/sustain state machine,
  ``img2midi``, ``piano_roll_to_midi``, the square ⇄ rect layout shuffles
  (``square_to_rect``, ``rect_to_square``, ``regroup_lines``) and
  ``img_file_2_midi_file``;
- the augmentations ``RandomBarCrop`` and ``stack_piano_rolls``;
- ``calc_note_metrics``: onset/sustain sensitivity, specificity, precision
  and F1, plus the TP/TN/FP/FN mask images, on the port's ``g2rgb``.

Both packages give equal images and metrics for the same inputs
(tests/test_torch_midi.py).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image, ImageOps

from .midi_io import MidiFile, MidiInstrument, MidiNote, read_midi, write_midi

__all__ = [
    "piano_roll_to_midi", "get_piano_rolls", "piano_roll_to_img",
    "midi_to_pr_img", "img2midi", "img2midi_multi", "img_file_2_midi_file",
    "square_to_rect", "rect_to_square", "regroup_lines", "filter_redgreen",
    "RandomBarCrop", "stack_piano_rolls", "calc_note_metrics",
    "square_to_rect_file",
    "chord_num_to_color", "simplify_chord", "load_chord_annotations",
]

CHORD_BORDER = 1        # (reference: pianoroll.py:18)
ONSET_STYLE = "start"   # (reference: pianoroll.py:19)


# --------------------------------------------------------------------------
# layout shuffles
# --------------------------------------------------------------------------

def square_to_rect(img: Image.Image) -> Image.Image:
    """256×256 → 512×128: bottom half mirrored and attached on the right
    (reference: pianoroll.py:363-374)."""
    w, h = img.size
    out = Image.new(img.mode, (w * 2, h // 2))
    out.paste(img.crop((0, 0, w, h // 2)), (0, 0))
    out.paste(img.crop((0, h // 2, w, h)).transpose(Image.FLIP_LEFT_RIGHT),
              (w, 0))
    return out


def rect_to_square(img: Image.Image) -> Image.Image:
    """512×128 → 256×256 (reference: pianoroll.py:376-382)."""
    w, h = img.size
    out = Image.new(img.mode, (w // 2, h * 2))
    out.paste(img.crop((0, 0, w // 2, h)), (0, 0))
    out.paste(img.crop((w // 2, 0, w, h)).transpose(Image.FLIP_LEFT_RIGHT),
              (0, h))
    return out


def regroup_lines(img: Image.Image) -> Image.Image:
    """Rebuild a grid of 256² sub-images into long 512×128 lines
    (reference: pianoroll.py:384-410)."""
    if img.size[0] == 128:
        return img
    if img.size[0] == 256:
        out = Image.new("RGB", (512, 128))
    elif img.size[0] == 2048:
        out = Image.new("RGB", img.size)
    else:
        return img
    imnum = 0
    for row in range(0, img.size[0], 256):
        for col in range(0, img.size[1], 256):
            imnum += 1
            sub = square_to_rect(img.crop((col, row, col + 256, row + 256)))
            out.paste(sub, ((imnum - 1) % 4 * 512, (imnum - 1) // 4 * 128))
    return out


def square_to_rect_file(path: str) -> str:
    """Convert a square PNG on disk to its rect layout, returning the new
    path (helper for generate_samples' MIDI path)."""
    img = Image.open(path).convert("RGB")
    if img.size[0] == img.size[1]:
        img = square_to_rect(img)
    out = path.replace(".png", "_rect.png")
    img.save(out)
    return out


# --------------------------------------------------------------------------
# MIDI → piano roll
# --------------------------------------------------------------------------

def find_first_note_start(midi: MidiFile) -> float:
    return min((n.start for i in midi.instruments for n in i.notes),
               default=0.0)


def get_piano_rolls(midi: MidiFile, fs: float,
                    remove_leading_silence: bool = True) -> Dict[str, np.ndarray]:
    """Per-instrument (128, n_frames) velocity rolls for MELODY/PIANO/TOTAL
    with a forced 1-px gap before each onset (reference:
    pianoroll.py:112-154)."""
    duration = midi.get_end_time()
    first = find_first_note_start(midi) if remove_leading_silence else 0.0
    n_frames = max(1, int(np.ceil((duration - first) * fs)) + 1)
    rolls = {name: np.zeros((128, n_frames))
             for name in ("PIANO", "MELODY", "TOTAL")}
    for inst in midi.instruments:
        name = inst.name.upper()
        if name not in ("MELODY", "PIANO"):
            continue
        for note in inst.notes:
            s = note.start - first
            start = int(np.round(s * fs))
            dur = (note.end - note.start) * fs
            end = start + int(np.round(dur))
            if end == start:
                end = start + 1
            end = min(end, n_frames)
            rolls[name][note.pitch, start:end] = note.velocity
            rolls["TOTAL"][note.pitch, start:end] = note.velocity
            if start > 0:  # forced onset gap (reference :146-148)
                rolls[name][note.pitch, start - 1] = 0
                rolls["TOTAL"][note.pitch, start - 1] = 0
    return rolls


def _roll_to_rgb(pr: np.ndarray, add_onsets: bool = True,
                 onset_style: str = ONSET_STYLE) -> np.ndarray:
    """Velocity roll (128, T) → RGB uint8 (128, T, 3), green sustain at
    velocity·2, red onsets; vectorized version of the reference's pixel loops
    (pianoroll.py:174-207)."""
    green = np.clip(np.round(pr * 2), 0, 255).astype(np.uint8)
    rgb = np.zeros(green.shape + (3,), np.uint8)
    rgb[..., 1] = green
    if add_onsets:
        on = green > 0
        prev_off = np.zeros_like(on)
        prev_off[:, 0] = True
        prev_off[:, 1:] = ~on[:, :-1]
        if onset_style == "start":
            onset = on & prev_off
            rgb[..., 0] = np.where(onset, green, 0)
            rgb[..., 1] = np.where(onset, 0, green)
        elif onset_style == "early":
            # black pixel with a note to its right becomes red
            nxt_on = np.zeros_like(on)
            nxt_on[:, :-1] = on[:, 1:]
            early = (~on) & nxt_on
            rgb[..., 0] = np.where(early, 255, 0)
        else:
            raise ValueError(f"unknown onset_style {onset_style}")
    return rgb


def chord_num_to_color(chord_num: int, n_chords: int = 25) -> tuple:
    """Chord index → a saturated RGB color on an evenly-spaced hue wheel.

    First-party replacement for the reference's missing ``chords`` module
    (pianoroll.py:17 imports it commented-out; :220 calls it anyway). Evenly
    spacing hues keeps adjacent chord indices visually distinct; "N" (no
    chord, by convention index 0 when built via load_chord_annotations'
    sorted vocabulary) lands on pure red."""
    import colorsys
    h = (int(chord_num) % max(n_chords, 1)) / max(n_chords, 1)
    r, g, b = colorsys.hsv_to_rgb(h, 0.85, 1.0)
    return (int(r * 255), int(g * 255), int(b * 255))


def simplify_chord(name: str) -> str:
    """'C:maj7(b5)/3' → 'C:maj' — keep root + base quality, drop extensions,
    alterations and inversions. 'N' (no chord) passes through. Documented
    first-party semantics; the reference's ``simplify_chord`` lives in a
    module absent from its repo (pianoroll.py:17)."""
    name = name.strip()
    if ":" not in name:
        return name
    root, qual = name.split(":", 1)
    qual = qual.split("/")[0].split("(")[0]
    base = ""
    for ch in qual:
        if ch.isdigit():
            break
        base += ch
    return f"{root}:{base}" if base else root


def load_chord_annotations(chords_path: str, fs: float, all_chords: list,
                           simplify: bool = False) -> list:
    """Parse a POP909-style ``*_chords.txt`` (TSV: start_time, end_time,
    chord label; times in seconds) into frame-indexed dicts
    {'start','end','chord_name','chord_num'} (reference: pianoroll.py:
    287-302). Labels missing from ``all_chords`` get num -1 (gray bar)
    instead of the reference's ValueError-on-.index behavior."""
    with open(chords_path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    chords = []
    for ln in lines:
        start, end, chord = ln.split("\t")[:3]
        name = simplify_chord(chord) if simplify else chord
        chords.append({
            "start": int(np.floor(float(start) * fs)),
            "end": int(np.ceil(float(end) * fs)),
            "chord_name": name,
            "chord_num": all_chords.index(name) if name in all_chords else -1,
        })
    return chords


def _paint_chord_bars(img: Image.Image, chords: list, chord_names: bool,
                      n_chords: int) -> Image.Image:
    """Paste per-chord color rectangles into the top and bottom CHORD_BORDER
    rows (reference: pianoroll.py:210-228). Unknown chords (num -1) paint
    gray."""
    w, h = img.size
    for c in chords:
        num = int(c["chord_num"])
        color = (128, 128, 128) if num < 0 else chord_num_to_color(num,
                                                                   n_chords)
        x0, x1 = max(int(c["start"]), 0), min(int(c["end"]), w)
        if x1 <= x0:
            continue
        img.paste(color, (x0, h - CHORD_BORDER, x1, h))
        img.paste(color, (x0, 0, x1, CHORD_BORDER))
        if chord_names:
            from PIL import ImageDraw
            ImageDraw.Draw(img).text((x0, 0), c["chord_name"].replace(":", ""),
                                     fill=(255, 255, 255))
    return img


def piano_roll_to_img(pr: np.ndarray, output_dir: str, midi_name: str,
                      instrument: str, start_col: Optional[int] = None,
                      add_onsets: bool = True,
                      onset_style: str = ONSET_STYLE,
                      chords: Optional[list] = None,
                      chord_names: bool = False,
                      n_chords: int = 25) -> Optional[str]:
    """Save one instrument roll as a PNG, vertically flipped for display
    (reference: pianoroll.py:157-240). Optional chord-color bars in the
    CHORD_BORDER top/bottom rows (:210-228) — working here, see module
    docstring."""
    os.makedirs(os.path.join(output_dir, midi_name), exist_ok=True)
    fname = os.path.join(output_dir, midi_name,
                         f"{midi_name}_{instrument}.png")
    if start_col is not None:
        fname = fname.replace(".png", f"_{str(start_col).zfill(5)}.png")
    rgb = _roll_to_rgb(pr, add_onsets, onset_style)
    img = Image.fromarray(rgb, "RGB").transpose(Image.FLIP_TOP_BOTTOM)
    if 0 in img.size:
        return None
    if chords is not None:
        img = _paint_chord_bars(img, chords, chord_names, n_chords)
    img.save(fname)
    return fname


def midi_to_pr_img(midi_file: str, output_dir: str, add_onsets: bool = True,
                   filter_mp: bool = True,
                   remove_leading_silence: bool = True,
                   show_chords: bool = False,
                   all_chords: Optional[list] = None,
                   chord_names: bool = False,
                   simplify_chords: bool = False) -> list:
    """MIDI file → per-instrument piano-roll PNGs, tempo-normalized to
    fs = 8·bps (reference: pianoroll.py:260-319). With ``show_chords`` +
    ``all_chords``, reads the sibling ``*_chords.txt`` annotation file and
    paints chord-color bars (:287-302) — note remove_leading_silence shifts
    note frames but not chord times, matching the reference's behavior."""
    midi = read_midi(midi_file)
    has_melody = any(i.name.upper() == "MELODY" for i in midi.instruments)
    has_piano = any(i.name.upper() == "PIANO" for i in midi.instruments)
    if len(midi.instruments) == 1 and not midi.instruments[0].name:
        midi.instruments[0].name = "PIANO"
        has_piano = True
    if not (has_melody or has_piano):
        return []
    _, tempi = midi.get_tempo_changes()
    bps = float(tempi[0]) / 60.0
    fs = bps * 4.0 * 2  # 8 frames per beat (reference :284)
    chords = None
    if show_chords and all_chords is not None:
        chords_path = midi_file.replace(".mid", "_chords.txt")
        if os.path.exists(chords_path):
            chords = load_chord_annotations(chords_path, fs, all_chords,
                                            simplify=simplify_chords)
    if filter_mp:
        midi.instruments = [i for i in midi.instruments
                            if i.name.upper() in ("MELODY", "PIANO")]
    rolls = get_piano_rolls(midi, fs,
                            remove_leading_silence=remove_leading_silence)
    midi_name = os.path.basename(midi_file).split(".")[0]
    n_chords = len(all_chords) if all_chords else 25
    return [p for inst, pr in rolls.items()
            if (p := piano_roll_to_img(pr, output_dir, midi_name, inst,
                                       add_onsets=add_onsets, chords=chords,
                                       chord_names=chord_names,
                                       n_chords=n_chords))]


# --------------------------------------------------------------------------
# piano roll → MIDI
# --------------------------------------------------------------------------

def piano_roll_to_midi(piano_roll: np.ndarray, fs: float = 8,
                       program: int = 0) -> MidiFile:
    """(128, frames) velocity array → MidiFile via velocity-change events
    (reference: pianoroll.py:41-96)."""
    notes, frames = piano_roll.shape
    pr = np.pad(piano_roll, [(0, 0), (1, 1)])
    changes = np.nonzero(np.diff(pr).T)
    inst = MidiInstrument(program=program, name="PIANO")
    prev_vel = np.zeros(notes, int)
    on_time = np.zeros(notes)
    for time, note in zip(*changes):
        vel = int(np.clip(pr[note, time + 1], 0, 127))
        t = time / fs
        if vel > 0:
            if prev_vel[note] == 0:
                on_time[note] = t
                prev_vel[note] = vel
        else:
            inst.notes.append(MidiNote(pitch=int(note),
                                       velocity=int(prev_vel[note]),
                                       start=float(on_time[note]),
                                       end=float(t)))
            prev_vel[note] = 0
    mf = MidiFile(instruments=[inst], tempos=[(0.0, 120.0)])
    return mf


def blockout_topbottom_arr(arr: np.ndarray,
                           border: int = CHORD_BORDER) -> np.ndarray:
    """(reference: pianoroll.py:326-331)."""
    out = arr.copy()
    out[:border] = 0
    out[-border:] = 0
    return out


def _thresh_masks(arr: np.ndarray, thresh: int = 20):
    r, g, b = arr[..., 0].astype(int), arr[..., 1].astype(int), arr[..., 2].astype(int)
    red = (r > thresh) & (g < thresh) & (b < thresh)
    green = (r < thresh) & (g > thresh) & (b < thresh)
    white = (r > thresh) & (g > thresh) & (b > thresh)
    return red, green, white


def filter_redgreen(img: Image.Image, require_onsets: bool = True,
                    thresh: int = 20,
                    onset_style: str = ONSET_STYLE) -> Image.Image:
    """Onset/sustain pixel state machine (reference: pianoroll.py:424-458):
    keep only green runs that begin with a red onset (when require_onsets);
    red onsets convert to green intensity in 'start' style. Vectorized per
    column sweep (rows processed simultaneously)."""
    arr = np.array(img.convert("RGB"))
    h, w = arr.shape[:2]
    red, green, white = _thresh_masks(arr, thresh)
    out = np.zeros_like(arr)
    note_on = np.zeros(h, bool)
    for x in range(w):
        r, g, wh = red[:, x], green[:, x], white[:, x]
        keep_green = g & (note_on if require_onsets else np.ones(h, bool))
        if not require_onsets:
            out[wh, x, 1] = arr[wh, x, 1]
        if onset_style == "start":
            out[r, x, 1] = arr[r, x, 0]  # red → green at red intensity
        else:
            out[r, x, 0] = arr[r, x, 0]
        out[keep_green, x] = arr[keep_green, x]
        note_on = r | keep_green | (wh & ~np.asarray(require_onsets))
    out[:CHORD_BORDER] = 0
    out[-CHORD_BORDER:] = 0
    return Image.fromarray(out, "RGB")


def img2midi(img: Image.Image, draw_sep: int = 512) -> MidiFile:
    """Grayscale strip image → MidiFile (reference: pianoroll.py:334-360):
    cut >128-tall images into 128-row strips concatenated horizontally,
    velocities = pixel/2, optional separator ticks."""
    if img.size[1] > 128:
        arr = np.concatenate(
            [np.array(img.crop((0, i, img.size[0], i + 128)))
             for i in range(0, img.size[1], 128)], axis=1)
    else:
        arr = np.array(img)
    arr = blockout_topbottom_arr(arr)
    pr = np.asarray(arr * 0.5, np.int32)
    pr = np.flip(pr, axis=0)
    if draw_sep > 0:
        for i in range(draw_sep, pr.shape[-1], draw_sep):
            pr[35:-35, i] = 30
    pr = np.clip(pr, 0, 127)
    return piano_roll_to_midi(pr)


def img2midi_multi(img: Image.Image, require_onsets: bool = True,
                   separators: int = 512) -> MidiFile:
    """Grid image → MIDI (reference: pianoroll.py:466-480)."""
    img = img.convert("RGB")
    img = regroup_lines(img)
    img = filter_redgreen(img, require_onsets=require_onsets)
    arr = np.array(img)
    combined = np.clip(arr[..., 0].astype(int) + arr[..., 1].astype(int),
                       0, max(int(arr[..., 0].max()),
                              int(arr[..., 1].max()), 1))
    return img2midi(Image.fromarray(combined.astype(np.uint8), "L"),
                    draw_sep=separators)


def img_file_2_midi_file(img_file: str, output_path: str = "",
                         require_onsets: bool = True,
                         separators: int = 512) -> str:
    """(reference: pianoroll.py:482-492)."""
    img = Image.open(img_file)
    midi = img2midi_multi(img, require_onsets=require_onsets,
                          separators=separators)
    if not output_path:
        output_path = os.path.basename(img_file).replace(".png", ".mid")
    elif os.path.isdir(output_path):
        output_path = os.path.join(
            output_path, os.path.basename(img_file).replace(".png", ".mid"))
    write_midi(output_path, midi)
    return output_path


# --------------------------------------------------------------------------
# augmentations
# --------------------------------------------------------------------------

class RandomBarCrop:
    """Bar-aligned random crop of a rect piano-roll image
    (reference: pianoroll.py:522-547)."""

    def __init__(self, bar_length: int = 16, window_length: int = 512):
        self.bl = bar_length
        self.wl = window_length
        self.bic = window_length // bar_length

    def __call__(self, img: Image.Image,
                 rng: Optional[np.random.Generator] = None) -> Image.Image:
        rng = rng or np.random.default_rng()
        bars = img.size[0] // self.bl
        if self.bic >= bars:
            pad = self.wl - img.size[0] + 1
            img = ImageOps.expand(img, (0, 0, pad, 0), fill=0)
            bars = img.size[0] // self.bl
        start = int(rng.integers(0, bars - self.bic + 1)) * self.bl
        return img.crop((start, 0, start + self.wl, img.size[1]))


def stack_piano_rolls(img: Image.Image,
                      final_size: Tuple[int, int] = (256, 256)) -> Image.Image:
    """512×128 → 256×256 with the right half mirrored below
    (reference: pianoroll.py:551-574)."""
    if img.size[0] <= 128 and img.size[1] <= 128:
        return img
    half = img.size[0] // 2
    out = Image.new(img.mode, final_size)
    out.paste(img.crop((0, 0, half, img.size[1])), (0, 0))
    out.paste(ImageOps.mirror(img.crop((half, 0, 2 * half, img.size[1]))),
              (0, img.size[1]))
    return out


# --------------------------------------------------------------------------
# note metrics (reference: metrics.py:362-455)
# --------------------------------------------------------------------------

def calc_note_metrics(pred: np.ndarray, target: np.ndarray,
                      threshold: float = 0.4, keep_gray: bool = False,
                      return_images: bool = False):
    """Onset/sustain sensitivity, specificity, precision, F1 on binarized
    NHWC piano-roll images (reference: metrics.py:362-455). With
    ``return_images`` also returns the reference's per-pixel diagnostic
    images (metrics.py:396-455): ``{name}_{tp,tn,fp,fn}`` white masks and
    ``{name}_targpred`` (red=target, green=pred) as NHWC float arrays."""
    import torch

    from ..metrics import g2rgb
    pred = g2rgb(torch.as_tensor(np.asarray(pred, np.float32)),
                 keep_gray=keep_gray).numpy()
    target = g2rgb(torch.as_tensor(np.asarray(target, np.float32)),
                   keep_gray=keep_gray).numpy()
    minval, maxval = target.min(), target.max()
    denom = max(maxval - minval, 1e-8)
    pred_u = (np.clip(pred, minval, maxval) - minval) / denom
    targ_u = (target - minval) / denom
    pb = pred_u > threshold
    tb = targ_u > threshold
    out = {}
    images = {}
    for channel, name in ((0, "onset"), (1, "sustain")):
        p, t = pb[..., channel], tb[..., channel]
        masks = {"tp": p & t, "tn": ~p & ~t, "fp": p & ~t, "fn": ~p & t}
        tp, tn = float(masks["tp"].sum()), float(masks["tn"].sum())
        fp, fn = float(masks["fp"].sum()), float(masks["fn"].sum())
        out[f"{name}_sensitivity"] = tp / (tp + fn + 1e-8)
        out[f"{name}_specificity"] = tn / (tn + fp + 1e-8)
        out[f"{name}_precision"] = tp / (tp + fp + 1e-8)
        out[f"{name}_f1"] = 2 * tp / (2 * tp + fp + fn + 1e-8)
        if return_images:
            for k, m in masks.items():
                images[f"{name}_{k}"] = np.repeat(
                    m[..., None].astype(np.float32), 3, axis=-1)
            images[f"{name}_targpred"] = np.stack(
                [t.astype(np.float32), p.astype(np.float32),
                 np.zeros_like(t, np.float32)], axis=-1)
    if return_images:
        return out, images
    return out
