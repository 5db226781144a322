"""Block-level receiver state checkpoint/resume (SURVEY.md §5: the reference
has none; for a streaming receiver over long captures the resumable state is
small and explicit -- sample offset, acquisition results, BB/TS reassembly
state -- because the TPU design already carries all sync state explicitly
instead of hiding it in thread-local loop filters)."""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

import numpy as np


@dataclass
class ReceiverCheckpoint:
    sample_offset: int                 # absolute offset of the next frame
    cfo_hz: float
    fft_mode: int
    l1pre_bits: list                   # 200 ints; re-parse on resume
    ts_buf: list                       # TSAssembler._buf bytes
    ts_prev_crc: int | None
    ts_lost: bool
    frames_decoded: int

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "ReceiverCheckpoint":
        with open(path) as f:
            return cls(**json.load(f))


@dataclass
class StreamCheckpoint:
    """Streaming-receiver resume point (io.devices.StreamingReceiver): the
    RAW-device sample offset of the next undecoded frame's P1 plus the
    corrector and TS-reassembly state.  On resume the receiver seeks there
    and re-acquires; because the offset lands exactly on a frame boundary,
    the reassembled TS continues the interrupted one without duplicate or
    missing packets (verified by tests/test_devices.py)."""
    sample_offset: int                 # raw device samples before next frame
    cfo_hz: float                      # total NCO correction at save time
    sco_ppm: float                     # total resampler correction
    ts_buf: list                       # TSAssembler._buf bytes
    ts_prev_crc: int | None
    ts_lost: bool
    frames_decoded: int
    ts_packets: int = 0   # packets emitted by THIS run at save time (each
    #                       run's assembler starts fresh after a resume;
    #                       consumers trim their own sink output to this)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f)

    @classmethod
    def load(cls, path: str) -> "StreamCheckpoint":
        with open(path) as f:
            return cls(**json.load(f))


def capture_state(frame_start: int, stats, p1, l1pre,
                  assembler) -> ReceiverCheckpoint:
    return ReceiverCheckpoint(
        sample_offset=int(frame_start),
        cfo_hz=float(stats.cfo_hz),
        fft_mode=int(p1.fft_mode),
        l1pre_bits=[int(b) for b in l1pre.pack()],
        ts_buf=[int(b) for b in assembler._buf],
        ts_prev_crc=assembler._prev_crc,
        ts_lost=bool(assembler._lost),
        frames_decoded=int(stats.frames_decoded),
    )


def restore_assembler(ck: ReceiverCheckpoint, assembler) -> None:
    assembler._buf = np.array(ck.ts_buf, dtype=np.uint8)
    assembler._prev_crc = ck.ts_prev_crc
    assembler._lost = ck.ts_lost
