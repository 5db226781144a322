"""Live SDR vendor bindings: the framework's L0 hardware ingest.

The reference's device layer is native C++ against three vendor APIs
(SURVEY.md §2.1).  This module binds the same APIs through ctypes so the
identical read loops run under `StreamingReceiver`:

  - `SdrplayDevice` — the mir_sdr API (`reference/src/sdrplay/
    mir_sdr.h`): `mir_sdr_Init` at 9.2 Msps zero-IF 8 MHz, the blocking
    `mir_sdr_ReadPacket` loop, retune via `mir_sdr_SetRf` and AGC via
    `mir_sdr_SetGr` — the behavior of rx_sdrplay.cpp:88-291.
  - `AirspyDevice` — libairspy (`reference/src/libairspy/src/
    airspy.h`): open/set_sample_type(INT16_IQ)/set_samplerate(10 Msps)/
    start_rx with an async C callback that feeds the native SPSC ring —
    the behavior of rx_airspy.cpp:55-110, 209-277 with the A/B
    double-buffer handoff replaced by the lock-free ring.
  - `PlutoDevice` — the reference's custom hi-speed libusb driver API
    (`reference/src/libplutosdr/plutosdr_hi_speed_rx.h`): open with
    device info, the ordered rfbw/rate/rxlo/gain/channel-enable init of
    rx_plutosdr.cpp:91-128, and planar-int16 async transfers
    (rx_plutosdr.cpp:225-251) into the same ring.

The library path can be forced with `T2_MIR_SDR_LIB` / `T2_AIRSPY_LIB` /
`T2_PLUTOSDR_LIB`
(used by the test suite to substitute a mock driver built from
tests/fake_drivers/*.c); otherwise the system library is located with
ctypes.util.find_library.  `SignalEstimate` feedback is applied between
read blocks exactly as the reference's device thread does
(rx_sdrplay.cpp:158-197): retunes step the hardware LO, gain offsets step
the gain (reduction), resets are receiver-side only.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
import time

import numpy as np

from .devices import SDRDevice, SignalEstimate


def _load(env_var: str, names: list[str], what: str) -> ctypes.CDLL:
    path = os.environ.get(env_var)
    if path:
        return ctypes.CDLL(path)
    for name in names:
        found = ctypes.util.find_library(name)
        if found:
            return ctypes.CDLL(found)
    raise RuntimeError(
        f"{what} vendor library not found (tried {names}; set {env_var} "
        "to a library path to override). Attach the SDR and install its "
        "driver, or use a recorded capture / the tcp:// remote-radio "
        "front end (io/net.py).")


def _interleave_int16(i: np.ndarray, q: np.ndarray) -> np.ndarray:
    out = np.empty(2 * len(i), dtype=np.int16)
    out[0::2] = i
    out[1::2] = q
    return out


class SdrplayDevice(SDRDevice):
    """SdrPlay RSP front end over the mir_sdr API (rx_sdrplay.cpp).

    mir_sdr expresses gain as gain REDUCTION in dB (gRdB, larger = quieter);
    `SignalEstimate.gain_offset` is a gain *increase* request, so the AGC
    loop subtracts it from the current gRdB (the reference does the same:
    `gain_db -= signal->gain_offset`, rx_sdrplay.cpp:179-197).
    """

    sample_rate = 9.2e6          # max rate for the 10-bit ADC mode
    BW_8_MHZ = 8000              # mir_sdr_BW_8_000
    IF_ZERO = 0                  # mir_sdr_IF_Zero
    GR_MIN, GR_MAX = 20, 78      # valid gain-reduction range

    def __init__(self, lib_path: str | None = None):
        self.lib = (ctypes.CDLL(lib_path) if lib_path
                    else _load("T2_MIR_SDR_LIB",
                               ["mirsdrapi-rsp", "sdrplay_api"], "SdrPlay"))
        L = self.lib
        L.mir_sdr_ApiVersion.argtypes = [ctypes.POINTER(ctypes.c_float)]
        L.mir_sdr_Init.argtypes = [
            ctypes.c_int, ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        L.mir_sdr_ReadPacket.argtypes = [
            ctypes.POINTER(ctypes.c_short), ctypes.POINTER(ctypes.c_short),
            ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        L.mir_sdr_SetRf.argtypes = [ctypes.c_double, ctypes.c_int,
                                    ctypes.c_int]
        L.mir_sdr_SetGr.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        L.mir_sdr_DCoffsetIQimbalanceControl.argtypes = [ctypes.c_uint,
                                                         ctypes.c_uint]
        for fn in ("mir_sdr_ApiVersion", "mir_sdr_Init", "mir_sdr_Uninit",
                   "mir_sdr_ReadPacket", "mir_sdr_SetRf", "mir_sdr_SetGr",
                   "mir_sdr_DCoffsetIQimbalanceControl",
                   "mir_sdr_ReleaseDeviceIdx"):
            getattr(L, fn).restype = ctypes.c_int
        v = ctypes.c_float(0.0)
        L.mir_sdr_ApiVersion(ctypes.byref(v))
        self.api_version = float(v.value)
        self.rf_hz = 0.0
        self.gr_db = 40
        self._spp = 0            # samplesPerPacket from mir_sdr_Init
        self._xi = self._xq = None
        self._leftover = np.zeros(0, np.complex64)
        self._inited = False

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        """gain_db < 0 requests hardware AGC mode like the reference
        (rx_sdrplay.cpp:99-103): start at maximum gain reduction and let
        the receiver's AGC loop pull it in; otherwise gain_db IS the
        initial gain reduction."""
        L = self.lib
        if self._inited:
            L.mir_sdr_Uninit()
            self._inited = False
        # the framework runs its own feed-forward DC/IQ correction
        # (rx.frontend.DCIQCorrector); disable the API's, like the
        # reference (rx_sdrplay.cpp:93)
        err = L.mir_sdr_DCoffsetIQimbalanceControl(0, 0)
        if err:
            raise RuntimeError(f"mir_sdr_DCoffsetIQimbalanceControl: {err}")
        self.rf_hz = float(frequency_hz)
        # clamp to the valid gain-reduction range: the real mir_sdr_Init
        # rejects out-of-range gRdB (a default --gain 0 would otherwise
        # pass 0, below GR_MIN=20)
        self.gr_db = 78 if gain_db < 0 else int(np.clip(
            round(gain_db), self.GR_MIN, self.GR_MAX))
        spp = ctypes.c_int(0)
        err = L.mir_sdr_Init(self.gr_db, self.sample_rate / 1e6,
                             self.rf_hz / 1e6, self.BW_8_MHZ, self.IF_ZERO,
                             ctypes.byref(spp))
        if err:
            raise RuntimeError(f"mir_sdr_Init: error {err}")
        self._spp = int(spp.value)
        self._xi = (ctypes.c_short * self._spp)()
        self._xq = (ctypes.c_short * self._spp)()
        self._leftover = np.zeros(0, np.complex64)
        self._inited = True

    def read_block(self, n: int) -> np.ndarray | None:
        """Blocking mir_sdr_ReadPacket loop (rx_sdrplay.cpp:208-226):
        accumulates packets until >= n samples.  A read error with data in
        hand delivers the partial block; with nothing, end of stream."""
        if not self._inited:
            return None
        from .. import native
        out = [self._leftover]
        have = len(self._leftover)
        fsn = ctypes.c_uint(0)
        grc = ctypes.c_int(0)
        rfc = ctypes.c_int(0)
        fsc = ctypes.c_int(0)
        while have < n:
            err = self.lib.mir_sdr_ReadPacket(
                self._xi, self._xq, ctypes.byref(fsn), ctypes.byref(grc),
                ctypes.byref(rfc), ctypes.byref(fsc))
            if err:
                if have:
                    break
                return None
            iq = _interleave_int16(
                np.frombuffer(self._xi, dtype=np.int16, count=self._spp),
                np.frombuffer(self._xq, dtype=np.int16, count=self._spp))
            # 10-bit ADC at 9.2 Msps: +-512 LSB full scale
            out.append(native.int16_to_complex(iq, scale=1.0 / 512.0))
            have += self._spp
        x = np.concatenate(out)
        self._leftover = x[n:]
        return x[:n]

    def tune(self, frequency_hz: float) -> None:
        """Absolute retune (mir_sdr_SetRf with abs=1)."""
        self.rf_hz = float(frequency_hz)
        self.lib.mir_sdr_SetRf(self.rf_hz, 1, 0)

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            # the demodulator's residual CFO means the wanted channel sits
            # offset from the LO: move the LO onto it (rx_sdrplay.cpp:169)
            self.rf_hz += est.coarse_freq_offset
            self.lib.mir_sdr_SetRf(self.rf_hz, 1, 0)
        if est.change_gain:
            self.gr_db = int(np.clip(
                round(self.gr_db - est.gain_offset),
                self.GR_MIN, self.GR_MAX))
            self.lib.mir_sdr_SetGr(self.gr_db, 1, 0)

    def stop(self) -> None:
        if self._inited:
            self.lib.mir_sdr_Uninit()
            self.lib.mir_sdr_ReleaseDeviceIdx()
            self._inited = False


class _AirspyTransfer(ctypes.Structure):
    _fields_ = [("device", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p),
                ("samples", ctypes.c_void_p),
                ("sample_count", ctypes.c_int),
                ("dropped_samples", ctypes.c_uint64),
                ("sample_type", ctypes.c_int)]


_AIRSPY_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_AirspyTransfer))
_AIRSPY_SAMPLE_INT16_IQ = 2


class AirspyDevice(SDRDevice):
    """AirSpy front end over libairspy (rx_airspy.cpp): 10 Msps INT16
    interleaved IQ via the async `airspy_start_rx` callback chain.  The
    callback (a C->Python trampoline, the rx_callback/rx_execute pair of
    rx_airspy.cpp:209-277) pushes converted samples into the native SPSC
    ring; `read_block` pops.  A full ring drops the transfer and counts an
    overrun — an async USB callback must never block (the reference resets
    its elastic buffer the same way, rx_airspy.cpp:266-276)."""

    sample_rate = 10.0e6
    GAIN_MIN, GAIN_MAX = 0, 21   # sensitivity-gain index range

    def __init__(self, lib_path: str | None = None,
                 ring_samples: int = 1 << 22):
        self.lib = (ctypes.CDLL(lib_path) if lib_path
                    else _load("T2_AIRSPY_LIB", ["airspy"], "AirSpy"))
        L = self.lib
        L.airspy_list_devices.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                          ctypes.c_int]
        L.airspy_open_sn.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_uint64]
        L.airspy_set_sample_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
        L.airspy_set_samplerate.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        L.airspy_set_rf_bias.argtypes = [ctypes.c_void_p, ctypes.c_uint8]
        L.airspy_set_sensitivity_gain.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_uint8]
        L.airspy_set_freq.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        L.airspy_start_rx.argtypes = [ctypes.c_void_p, _AIRSPY_CB,
                                      ctypes.c_void_p]
        L.airspy_stop_rx.argtypes = [ctypes.c_void_p]
        L.airspy_is_streaming.argtypes = [ctypes.c_void_p]
        L.airspy_close.argtypes = [ctypes.c_void_p]
        for fn in ("airspy_list_devices", "airspy_open_sn",
                   "airspy_set_sample_type", "airspy_set_samplerate",
                   "airspy_set_rf_bias", "airspy_set_sensitivity_gain",
                   "airspy_set_freq", "airspy_start_rx", "airspy_stop_rx",
                   "airspy_is_streaming", "airspy_close"):
            getattr(L, fn).restype = ctypes.c_int
        self._dev = ctypes.c_void_p(None)
        self._ring = None
        self._ring_samples = ring_samples
        self.rf_hz = 0.0
        self.gain = 10
        self.overruns = 0
        self.dropped_samples = 0
        self._started = False
        self._lock = threading.Lock()
        # the trampoline must outlive the stream: libairspy holds the raw
        # function pointer
        self._cb = _AIRSPY_CB(self._on_transfer)

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        L = self.lib
        serials = (ctypes.c_uint64 * 4)()
        count = L.airspy_list_devices(serials, 4)
        if count <= 0:
            raise RuntimeError("no AirSpy device found")
        err = L.airspy_open_sn(ctypes.byref(self._dev), serials[0])
        if err:
            raise RuntimeError(f"airspy_open_sn: {err}")
        for call, val in ((L.airspy_set_sample_type,
                           _AIRSPY_SAMPLE_INT16_IQ),
                          (L.airspy_set_samplerate,
                           int(self.sample_rate)),
                          (L.airspy_set_rf_bias, 0)):
            err = call(self._dev, val)
            if err:
                raise RuntimeError(f"airspy init call failed: {err}")
        self.rf_hz = float(frequency_hz)
        if self.rf_hz:
            L.airspy_set_freq(self._dev, int(self.rf_hz))
        self.gain = int(np.clip(round(gain_db), self.GAIN_MIN,
                                self.GAIN_MAX))
        L.airspy_set_sensitivity_gain(self._dev, self.gain)
        from .. import native
        self._ring = native.IQRing(self._ring_samples)

    def _on_transfer(self, transfer) -> int:
        t = transfer.contents
        if not t.samples or t.sample_count <= 0:
            return 0
        n16 = 2 * t.sample_count
        raw = np.ctypeslib.as_array(
            ctypes.cast(t.samples, ctypes.POINTER(ctypes.c_int16)),
            shape=(n16,))
        if t.dropped_samples:
            self.dropped_samples += int(t.dropped_samples)
        # AirSpy INT16 mode delivers 12-bit-scaled samples; the native
        # ring converts while copying (ring_push_int16, ingest.cpp)
        took = self._ring.push_int16(raw, scale=1.0 / 2048.0)
        if took < t.sample_count:
            self.overruns += 1
        return 0

    def start(self) -> None:
        if not self._started:
            err = self.lib.airspy_start_rx(self._dev, self._cb, None)
            if err:
                raise RuntimeError(f"airspy_start_rx: {err}")
            self._started = True

    def read_block(self, n: int) -> np.ndarray | None:
        if self._ring is None:
            return None
        self.start()
        out = []
        have = 0
        while have < n:
            got = self._ring.pop(n - have)
            if len(got):
                out.append(got)
                have += len(got)
                continue
            if not self.lib.airspy_is_streaming(self._dev):
                # stream ended: drain whatever raced in, then EOF
                got = self._ring.pop(n - have)
                if len(got):
                    out.append(got)
                    have += len(got)
                break
            time.sleep(0.001)
        if not out:
            return None
        return np.concatenate(out)

    def tune(self, frequency_hz: float) -> None:
        self.rf_hz = float(frequency_hz)
        self.lib.airspy_set_freq(self._dev, int(self.rf_hz))

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            self.rf_hz += est.coarse_freq_offset
            self.lib.airspy_set_freq(self._dev, int(self.rf_hz))
        if est.change_gain:
            self.gain = int(np.clip(round(self.gain + est.gain_offset / 3.0),
                                    self.GAIN_MIN, self.GAIN_MAX))
            self.lib.airspy_set_sensitivity_gain(self._dev, self.gain)

    def flush(self) -> None:
        if self._ring is not None:
            self._ring.flush()

    def stop(self) -> None:
        if self._started:
            self.lib.airspy_stop_rx(self._dev)
            self._started = False
        if self._dev:
            self.lib.airspy_close(self._dev)
            self._dev = ctypes.c_void_p(None)
        if self._ring is not None:
            self._ring.close()
            self._ring = None


class _PlutoInfo(ctypes.Structure):
    _fields_ = [("serial_number", ctypes.c_ubyte * 2048),
                ("serial_number_len", ctypes.c_int),
                ("samples_type", ctypes.c_int),
                ("len_out", ctypes.c_uint32)]


class _PlutoTransfer(ctypes.Structure):
    _fields_ = [("device", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p),
                ("i_samples", ctypes.POINTER(ctypes.c_int16)),
                ("q_samples", ctypes.POINTER(ctypes.c_int16)),
                ("sample_count", ctypes.c_int)]


_PLUTO_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(_PlutoTransfer))
_PLUTO_SAMPLES_IQ = 0


class PlutoDevice(SDRDevice):
    """PlutoSDR front end over the reference's custom hi-speed libusb
    driver API (libplutosdr/plutosdr_hi_speed_rx.h): 9.2 Msps 12-bit IQ
    with PLANAR int16 transfers delivered by the async `plutosdr_start_rx`
    callback (rx_plutosdr.cpp:225-251).  Init follows the reference's
    strict order — rfbw BEFORE sample rate (rx_plutosdr.cpp:104-120) —
    then both buffer channels and the bufstream are enabled.  The
    trampoline interleaves i/q and pushes into the native SPSC ring;
    `read_block` pops with a stall deadline (the API exposes no
    is_streaming probe — a pump that delivers nothing for `stall_timeout`
    seconds is treated as end of stream).

    NOTE the reference additionally ssh-es into the Pluto to insmod its
    USB-gadget kernel module before opening (rx_plutosdr.cpp:324+,
    pluto_kernel_patch).  That device-side provisioning is out of scope
    here: run it once per boot from the shipped module, or use the
    remote-radio front end (io/net.py) next to the Pluto instead."""

    sample_rate = 9.2e6
    GAIN_MIN_DB, GAIN_MAX_DB = 0, 71     # AD9361 RX gain range

    def __init__(self, lib_path: str | None = None,
                 ring_samples: int = 1 << 22, stall_timeout: float = 2.0):
        self.lib = (ctypes.CDLL(lib_path) if lib_path
                    else _load("T2_PLUTOSDR_LIB", ["plutosdr_hi_speed_rx",
                                                   "plutosdr"], "PlutoSDR"))
        L = self.lib
        L.plutosdr_get_device_count.restype = ctypes.c_uint32
        L.plutosdr_get_device_count.argtypes = []
        L.plutosdr_open.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                    ctypes.c_uint8,
                                    ctypes.POINTER(_PlutoInfo)]
        L.plutosdr_set_rfbw.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        L.plutosdr_set_sample_rate.argtypes = [ctypes.c_void_p,
                                               ctypes.c_uint32]
        L.plutosdr_set_rxlo.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        L.plutosdr_set_gainctl_manual.argtypes = [ctypes.c_void_p]
        L.plutosdr_set_gain_mdb.argtypes = [ctypes.c_void_p,
                                            ctypes.c_uint32]
        L.plutosdr_buffer_channel_enable.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]
        L.plutosdr_bufstream_enable.argtypes = [ctypes.c_void_p,
                                                ctypes.c_uint32]
        L.plutosdr_start_rx.argtypes = [ctypes.c_void_p, _PLUTO_CB,
                                        ctypes.c_void_p]
        L.plutosdr_stop_rx.argtypes = [ctypes.c_void_p]
        L.plutosdr_close.argtypes = [ctypes.c_void_p]
        for fn in ("plutosdr_open", "plutosdr_set_rfbw",
                   "plutosdr_set_sample_rate", "plutosdr_set_rxlo",
                   "plutosdr_set_gainctl_manual", "plutosdr_set_gain_mdb",
                   "plutosdr_buffer_channel_enable",
                   "plutosdr_bufstream_enable", "plutosdr_start_rx",
                   "plutosdr_stop_rx", "plutosdr_close"):
            getattr(L, fn).restype = ctypes.c_int
        self._dev = ctypes.c_void_p(None)
        self._ring = None
        self._ring_samples = ring_samples
        self._stall_timeout = float(stall_timeout)
        self.serial = ""
        self.len_out = 0
        self.rf_hz = 0.0
        self.gain_db = 0
        self.overruns = 0
        self._started = False
        self._cb = _PLUTO_CB(self._on_transfer)

    def init(self, frequency_hz: float, gain_db: float = 0.0) -> None:
        L = self.lib
        if L.plutosdr_get_device_count() == 0:
            raise RuntimeError("no PlutoSDR device found")
        info = _PlutoInfo()
        info.samples_type = _PLUTO_SAMPLES_IQ
        err = L.plutosdr_open(ctypes.byref(self._dev), 0,
                              ctypes.byref(info))
        if err:
            raise RuntimeError(f"plutosdr_open: {err}")
        self.serial = bytes(info.serial_number[:info.serial_number_len]
                            ).decode("ascii", "replace")
        self.len_out = int(info.len_out)
        self.rf_hz = float(frequency_hz)
        self.gain_db = int(np.clip(round(gain_db), self.GAIN_MIN_DB,
                                   self.GAIN_MAX_DB))
        # set rfbw FIRST (the reference marks this order as mandatory)
        for call, args in ((L.plutosdr_set_rfbw, (8_000_000,)),
                           (L.plutosdr_set_sample_rate,
                            (int(self.sample_rate),)),
                           (L.plutosdr_set_rxlo, (int(self.rf_hz),)),
                           (L.plutosdr_set_gainctl_manual, ()),
                           (L.plutosdr_set_gain_mdb,
                            (self.gain_db * 1000,)),
                           (L.plutosdr_buffer_channel_enable, (0, 1)),
                           (L.plutosdr_buffer_channel_enable, (1, 1)),
                           (L.plutosdr_bufstream_enable, (1,))):
            err = call(self._dev, *args)
            if err:
                raise RuntimeError(
                    f"plutosdr init call {call.__name__} failed: {err}")
        from .. import native
        self._ring = native.IQRing(self._ring_samples)

    def _on_transfer(self, transfer) -> int:
        t = transfer.contents
        n = t.sample_count
        if not t.i_samples or not t.q_samples or n <= 0:
            return 0
        i = np.ctypeslib.as_array(t.i_samples, shape=(n,))
        q = np.ctypeslib.as_array(t.q_samples, shape=(n,))
        # 12-bit ADC: +-2048 LSB full scale (dvbt2_demodulator.cpp:45-47)
        took = self._ring.push_int16(_interleave_int16(i, q),
                                     scale=1.0 / 2048.0)
        if took < n:
            self.overruns += 1
        return 0

    def start(self) -> None:
        if not self._started:
            err = self.lib.plutosdr_start_rx(self._dev, self._cb, None)
            if err:
                raise RuntimeError(f"plutosdr_start_rx: {err}")
            self._started = True

    def read_block(self, n: int) -> np.ndarray | None:
        if self._ring is None:
            return None
        self.start()
        out = []
        have = 0
        deadline = time.monotonic() + self._stall_timeout
        while have < n:
            got = self._ring.pop(n - have)
            if len(got):
                out.append(got)
                have += len(got)
                deadline = time.monotonic() + self._stall_timeout
                continue
            if time.monotonic() > deadline:
                break  # pump silent past the stall deadline: stream ended
            time.sleep(0.001)
        if not out:
            return None
        return np.concatenate(out)

    def tune(self, frequency_hz: float) -> None:
        # the rxlo register is integer Hz: store what the hardware got
        self.rf_hz = float(round(frequency_hz))
        self.lib.plutosdr_set_rxlo(self._dev, int(self.rf_hz))

    def apply(self, est: SignalEstimate) -> None:
        if est.change_frequency:
            # move the LO onto the discovered offset (rx_plutosdr.cpp:182)
            self.tune(self.rf_hz + est.coarse_freq_offset)
        if est.change_gain:
            self.gain_db = int(np.clip(
                round(self.gain_db + est.gain_offset),
                self.GAIN_MIN_DB, self.GAIN_MAX_DB))
            self.lib.plutosdr_set_gain_mdb(self._dev, self.gain_db * 1000)

    def flush(self) -> None:
        if self._ring is not None:
            self._ring.flush()

    def stop(self) -> None:
        if self._started:
            self.lib.plutosdr_stop_rx(self._dev)
            self._started = False
        if self._dev:
            self.lib.plutosdr_close(self._dev)
            self._dev = ctypes.c_void_p(None)
        if self._ring is not None:
            self._ring.close()
            self._ring = None
