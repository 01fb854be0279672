"""Transcription output writers: txt / vtt / srt / lrc / csv / json / wts.

Parity with the reference CLI's output helpers (examples/main/main.cpp
output_txt/output_vtt/output_srt/output_lrc/output_csv/output_json — the
upstream whisper.cpp set the fork kept flags for) including the centisecond
timestamp formatting of to_timestamp (src/qwen2-whisper.cpp:2386-2400).
"""

from __future__ import annotations

import json


def format_timestamp(t_cs: int, comma: bool = False) -> str:
    """Centiseconds -> HH:MM:SS.mmm (≙ to_timestamp :2386-2400)."""
    msec = t_cs * 10
    hr, msec = divmod(msec, 3600 * 1000)
    minute, msec = divmod(msec, 60 * 1000)
    sec, msec = divmod(msec, 1000)
    sep = "," if comma else "."
    return f"{hr:02d}:{minute:02d}:{sec:02d}{sep}{msec:03d}"


def _lrc_timestamp(t_cs: int) -> str:
    msec = t_cs * 10
    minute, msec = divmod(msec, 60 * 1000)
    sec, msec = divmod(msec, 1000)
    return f"{minute:02d}:{sec:02d}.{msec // 10:02d}"


def write_txt(path: str, segments: list[dict]) -> None:
    with open(path, "w") as f:
        for s in segments:
            f.write(s["text"].strip() + "\n")


def write_vtt(path: str, segments: list[dict]) -> None:
    with open(path, "w") as f:
        f.write("WEBVTT\n\n")
        for s in segments:
            f.write(f"{format_timestamp(s['t0'])} --> "
                    f"{format_timestamp(s['t1'])}\n")
            f.write(s["text"].strip() + "\n\n")


def write_srt(path: str, segments: list[dict], start: int = 1) -> None:
    """start ≙ the CLI's -on/--offset-n segment index offset (reference
    examples/main/main.cpp:127 parses it; SRT numbering is where a
    segment index is part of the output format)."""
    with open(path, "w") as f:
        for i, s in enumerate(segments, start):
            f.write(f"{i}\n")
            f.write(f"{format_timestamp(s['t0'], comma=True)} --> "
                    f"{format_timestamp(s['t1'], comma=True)}\n")
            f.write(s["text"].strip() + "\n\n")


def write_lrc(path: str, segments: list[dict]) -> None:
    with open(path, "w") as f:
        f.write("[by:qwen2-audio-tpu]\n")
        for s in segments:
            f.write(f"[{_lrc_timestamp(s['t0'])}]{s['text'].strip()}\n")


def write_csv(path: str, segments: list[dict]) -> None:
    with open(path, "w") as f:
        f.write("start,end,text\n")
        for s in segments:
            text = s["text"].strip().replace('"', '""')
            f.write(f'{s["t0"] * 10},{s["t1"] * 10},"{text}"\n')


def _token_objs(s: dict) -> list[dict]:
    """Per-token objects for the full JSON format (-ojf): id + surface
    text, probability when the decode recorded it, and DTW token
    timestamps when token_timestamps produced them — every token is
    emitted even if a side-channel list is missing."""
    ids = s.get("tokens", [])
    texts = s.get("token_texts") or []
    probs = s.get("probs") or []
    times = s.get("token_times")
    out = []
    for i, tid in enumerate(ids):
        tok = {"text": texts[i] if i < len(texts) else "", "id": tid}
        if i < len(probs):
            tok["p"] = probs[i]
        if times is not None and i < len(times):
            tok["timestamps"] = {"from": format_timestamp(times[i],
                                                          comma=True)}
            tok["offsets"] = {"from": times[i] * 10}
        out.append(tok)
    return out


def write_json(path: str, segments: list[dict], *, model: str = "",
               language: str = "en", full: bool = False) -> None:
    doc = {
        "systeminfo": "",
        "model": {"type": model},
        "params": {"language": language},
        "result": {"language": language},
        "transcription": [
            {
                "timestamps": {
                    "from": format_timestamp(s["t0"], comma=True),
                    "to": format_timestamp(s["t1"], comma=True),
                },
                "offsets": {"from": s["t0"] * 10, "to": s["t1"] * 10},
                "text": s["text"],
                **({"tokens": _token_objs(s)} if full else {}),
            }
            for s in segments
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, ensure_ascii=False)


WRITERS = {
    "txt": write_txt,
    "vtt": write_vtt,
    "srt": write_srt,
    "lrc": write_lrc,
    "csv": write_csv,
    "json": write_json,
}


# probability color ramp for -pc (≙ upstream whisper.cpp k_colors: 10
# ANSI steps red -> green; the fork kept the flag, examples/main/main.cpp:155)
K_COLORS = ["\033[38;5;196m", "\033[38;5;202m", "\033[38;5;208m",
            "\033[38;5;214m", "\033[38;5;220m", "\033[38;5;226m",
            "\033[38;5;190m", "\033[38;5;154m", "\033[38;5;118m",
            "\033[38;5;82m"]
ANSI_RESET = "\033[0m"


def colorize_segment(seg: dict) -> str:
    """Per-token probability coloring (≙ upstream main.cpp print with
    params.print_colors: col = max(0, min(9, 3*p*p*p*10 - 0.01))). Falls
    back to plain text when the segment has no per-token surfaces."""
    probs = seg.get("probs")
    tokens = seg.get("token_texts") or None
    if not probs or tokens is None or len(tokens) != len(probs):
        return seg["text"]
    parts = []
    for surface, p in zip(tokens, probs):
        col = max(0, min(9, int(3.0 * p * p * p * 10.0 - 0.01)))
        parts.append(f"{K_COLORS[col]}{surface}{ANSI_RESET}")
    return "".join(parts)


def write_wts(path: str, segments: list[dict], audio_path: str,
              duration_cs: int, font_path: str =
              "/System/Library/Fonts/Supplemental/Courier New Bold.ttf"
              ) -> None:
    """Karaoke video bash script (-owts): ffmpeg drawtext windows driven
    by per-token DTW times — the role of upstream whisper.cpp's
    output_wts (the fork kept the -owts/--font-path flags,
    examples/main/main.cpp:146,211-212, but stripped the writer with the
    decoder). Requires token_timestamps (the CLI forces them on)."""
    def esc(s: str) -> str:
        return s.replace("\\", "\\\\").replace("'", "’") \
                .replace('"', "\\\"").replace(":", "\\:").replace("%", "\\%")

    filters = []
    for seg in segments:
        times = seg.get("token_times")
        toks = seg.get("token_texts")
        if times and toks:
            # one window per token: spoken-so-far prefix in yellow
            windows = [(tt, times[i + 1] if i + 1 < len(times)
                        else seg["t1"],
                        "".join(toks[: i + 1]).strip())
                       for i, tt in enumerate(times)]
        else:
            windows = [(seg["t0"], seg["t1"], seg["text"].strip())]
        for t0, t1, text in windows:
            if t1 <= t0 or not text:
                continue
            filters.append(
                f"drawtext=fontfile='{font_path}':fontsize=24:"
                f"fontcolor=yellow:x=(w-text_w)/2:y=h/2:"
                f"text='{esc(text)}':"
                f"enable='between(t,{t0 / 100.0},{t1 / 100.0})'")
    script = (
        "#!/bin/bash\n"
        "# generated by qwen2-audio-tpu (-owts); run to render a karaoke "
        "video\n"
        f"ffmpeg -i '{audio_path}' -f lavfi -i "
        f"color=size=1200x120:duration={duration_cs / 100.0}:rate=25:"
        "color=black -vf \"" + ",".join(filters) + "\" "
        f"-c:v libx264 -pix_fmt yuv420p -shortest -y '{path}.mp4'\n")
    with open(path, "w") as f:
        f.write(script)


def write_outputs(base_path: str, segments: list[dict], args) -> list[str]:
    """Write every format the CLI flags request; returns written paths."""
    written = []
    base = args.output_file or base_path
    if base.endswith((".wav", ".mp3")):
        base = base[:-4]
    json_full = getattr(args, "output_json_full", False)
    for fmt, flag in (("txt", args.output_txt), ("vtt", args.output_vtt),
                      ("srt", args.output_srt), ("lrc", args.output_lrc),
                      ("csv", args.output_csv),
                      ("json", args.output_json or json_full)):
        if flag:
            path = f"{base}.{fmt}"
            if fmt == "srt":
                write_srt(path, segments,
                          start=1 + getattr(args, "offset_n", 0))
            elif fmt == "json":
                # -ojf implies -oj with per-token detail (main.cpp:151)
                write_json(path, segments, full=json_full)
            else:
                WRITERS[fmt](path, segments)
            written.append(path)
    return written
