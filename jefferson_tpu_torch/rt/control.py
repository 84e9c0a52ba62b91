"""Live interactive source control — the reference's keyboard loop: a copy
of ``jefferson_tpu/rt/control.py``.

The reference's defining interactive feature is a user moving the sound
source in real time while the audio follows: GLUT key handlers mutate the
source's Cartesian ``coordinates`` each frame (reference:
Jefferson/src/graphics.cu:487-601) and the audio thread reads them via
``updateFromCartesian`` (graphics.cu:376-386).  This module is that control
surface re-built headless: a thread-safe Cartesian position state with the
reference's exact key semantics, plus a raw-TTY reader so ``jefferson-rt
--keys`` gets WASD/arrow control in any terminal (no GL window needed).

Key map (reference graphics.cu:487-601, step ``temp`` = 0.05,
graphics.cu:21):

  w/s     move the source up/down          (y +/- 0.05)
  a/d     move left/right                  (x -/+ 0.05)
  left/right arrows                        (x -/+ 0.05, same as a/d)
  up/down arrows    move away/toward       (z -/+ 0.05)
  r       reset the source to (0.5, 0, 0)  (graphics.cu:495-502)
  q/ESC   quit                             (graphics.cu:526-535)

Every move is guarded so the resulting elevation stays above -40 deg (the
KEMAR grid's floor — the clamp at graphics.cu:601 region); the guard
reproduces the reference's exact (quirky) per-key conditions, including
that w/s are unguarded while y >= 0.
"""

from __future__ import annotations

import math
import threading

KEY_STEP = 0.05  # reference graphics.cu:21 ``float temp = 0.05f``

# initial coordinates: the SoundSource constructor state
# (reference: Jefferson/src/SoundSource.cu:8-10)
INITIAL_XYZ = (0.0, 0.0, 0.5)
# the 'r' key's reset position (reference: graphics.cu:499-501 — note it
# differs from the constructor state; preserved as-is)
RESET_XYZ = (0.5, 0.0, 0.0)

_DEG = 180.0 / math.pi


def _ele_deg(y: float, horiz: float) -> float:
    """atan(y / horiz) in degrees; horiz is a sqrt (>= 0), and atan2 gives
    the C atan(+-inf) = +-90 semantics at horiz == 0."""
    return math.atan2(y, horiz) * _DEG


class SourceControl:
    """Thread-safe live source position (the GLUT-handler state, headless).

    The control thread (TTY reader, daemon command handler, a test) calls
    ``apply_key``/``move_to``; the audio thread reads ``coordinates()`` once
    per block and feeds it to ``StreamingSpatializer.set_position_cartesian``
    — the same writer/reader split as the reference's graphics/audio threads
    (benign race there; an actual lock here).
    """

    def __init__(self, xyz: tuple[float, float, float] = INITIAL_XYZ):
        self._lock = threading.Lock()
        self.x, self.y, self.z = (float(v) for v in xyz)
        self.quit = False
        self.moves = 0  # how many keys actually changed the position

    def coordinates(self) -> tuple[float, float, float]:
        with self._lock:
            return (self.x, self.y, self.z)

    def move_to(self, x: float, y: float, z: float) -> None:
        with self._lock:
            self.x, self.y, self.z = float(x), float(y), float(z)
            self.moves += 1

    def apply_key(self, key: str) -> bool:
        """Apply one key (see module key map). Returns False on quit."""
        step = KEY_STEP
        with self._lock:
            x, y, z = self.x, self.y, self.z
            if key in ("q", "esc"):
                self.quit = True
                return False
            if key in ("r", "R"):
                self.x, self.y, self.z = RESET_XYZ
                self.moves += 1
                return True
            moved = False
            if key in ("w", "W"):
                # guard: while y >= 0 always allowed; below the horizon only
                # if the result stays above -40 deg (graphics.cu:505-507)
                dist = math.sqrt(x * x + z * z)
                if y >= 0 or _ele_deg(y + step, dist) > -40:
                    self.y = y + step
                    moved = True
            elif key in ("s", "S"):
                dist = math.sqrt(x * x + z * z)
                if y >= 0 or _ele_deg(y - step, dist) > -40:
                    self.y = y - step
                    moved = True
            elif key in ("a", "A", "left"):
                if _ele_deg(y, math.sqrt((x - step) ** 2 + z * z)) > -40:
                    self.x = x - step
                    moved = True
            elif key in ("d", "D", "right"):
                if _ele_deg(y, math.sqrt((x + step) ** 2 + z * z)) > -40:
                    self.x = x + step
                    moved = True
            elif key == "up":  # away from the listener (graphics.cu:548-551)
                if _ele_deg(y, math.sqrt(x * x + (z - step) ** 2)) > -40:
                    self.z = z - step
                    moved = True
            elif key == "down":
                if _ele_deg(y, math.sqrt(x * x + (z + step) ** 2)) > -40:
                    self.z = z + step
                    moved = True
            if moved:
                self.moves += 1
            return True


def spherical_to_control_xyz(azi_deg: float, ele_deg: float, r: float):
    """Cartesian point that ``updateFromCartesian`` reads back as exactly
    (azi, ele, r) — the inverse of the CARTESIAN reading convention
    (reference: Jefferson/src/SoundSource.cu:20-36):

        x = -r cos(ele) sin(azi),  y = r sin(ele),  z = -r cos(ele) cos(azi)

    NOT trajectory.spatial.spherical_to_cartesian: that ports the
    reference's ``updateFromSpherical`` quirk (no cos(ele) factor on the
    horizontal components), whose output reads back MIRRORED in azimuth
    through updateFromCartesian — fine for the offline planner (which keeps
    the given angles and only takes |xyz| for the radius) but wrong for a
    live control surface feeding set_position_cartesian."""
    a = math.radians(azi_deg)
    e = math.radians(ele_deg)
    return (
        -r * math.cos(e) * math.sin(a),
        r * math.sin(e),
        -r * math.cos(e) * math.cos(a),
    )


def decode_keys_partial(data: bytes) -> tuple[list[str], bytes]:
    """Raw TTY bytes -> (key names, undecoded tail).

    Handles ANSI escape sequences robustly: plain CSI/SS3 arrows map to
    'up/down/left/right'; any OTHER complete escape sequence (shift-arrows,
    Home, F-keys…) is consumed and IGNORED — it must never decode as 'esc'
    plus stray letter keys (a held arrow key can split across reads, and
    'A' is a real move key).  An incomplete sequence at the end of the
    buffer (including a lone trailing ESC, which may be the first byte of
    the next read's arrow) is returned as the tail for the caller to carry
    into the next read; ``tty_key_loop`` promotes a lone carried ESC to a
    real 'esc' press after a read timeout.
    """
    keys: list[str] = []
    i = 0
    n = len(data)
    arrows = {0x41: "up", 0x42: "down", 0x43: "right", 0x44: "left"}
    while i < n:
        b = data[i]
        if b != 0x1B:
            ch = chr(b)
            if ch.isprintable():
                keys.append(ch)
            i += 1
            continue
        if i + 1 >= n:
            return keys, data[i:]  # lone trailing ESC: maybe truncated
        nxt = data[i + 1]
        if nxt not in (0x5B, 0x4F):  # not CSI/SS3: a real ESC press
            keys.append("esc")
            i += 1
            continue
        # CSI/SS3: scan to the final byte (0x40-0x7E after any parameters)
        j = i + 2
        if nxt == 0x5B and j < n and data[j] == 0x5B:
            # Linux-console F1-F5 encode as ESC [ [ <letter> — the second
            # '[' would otherwise scan as the final byte, leaking the
            # letter as a real move key (F1 -> 'A' -> move left)
            j += 1
            if j >= n:
                return keys, data[i:]  # incomplete: carry
            i = j + 1  # consume and ignore the whole 4-byte sequence
            continue
        while j < n and not (0x40 <= data[j] <= 0x7E):
            j += 1
        if j >= n:
            return keys, data[i:]  # incomplete sequence: carry it
        if j == i + 2 and data[j] in arrows:  # plain arrow, no parameters
            keys.append(arrows[data[j]])
        # else: some other control sequence — consume and ignore
        i = j + 1
    return keys, b""


def decode_keys(data: bytes) -> list[str]:
    """decode_keys_partial treating ``data`` as complete (a lone trailing
    ESC is a real ESC press)."""
    keys, rest = decode_keys_partial(data)
    if rest == b"\x1b":
        keys.append("esc")
    # any other incomplete sequence tail is dropped
    return keys


def tty_key_loop(control: SourceControl, fd: int, on_key=None,
                 stop: threading.Event | None = None) -> None:
    """Raw-mode key loop on an ALREADY-cbreak fd; returns when the user
    quits (or ``stop`` is set).  Run in a daemon thread next to the audio
    loop (``jefferson-rt --keys``) — terminal mode save/restore is owned by
    the caller (see KeyThread), because a daemon thread's finally never
    runs when the playout loop ends on its own.

    Incomplete escape sequences carry across reads (a held arrow key splits
    at read boundaries); a carried lone ESC is promoted to a real 'esc'
    press after two read timeouts with no follow-up bytes (the same grace a
    partial CSI gets — over a laggy link an arrow's '[A' tail can trail its
    escape byte by more than one 50 ms window, and a mistaken promotion
    quits the whole session).
    ``on_key`` (optional) is called with (key, (x, y, z)) after each applied
    key — the CLI uses it to print the live position readout.
    """
    import os
    import select

    carry = b""
    stale = 0
    while not control.quit and (stop is None or not stop.is_set()):
        ready, _, _ = select.select([fd], [], [], 0.05)
        if not ready:
            if carry == b"\x1b":  # maybe a real ESC press...
                stale += 1
                if stale >= 2:  # ...but give a split arrow two windows
                    carry = b""
                    stale = 0
                    if not control.apply_key("esc"):
                        return
            elif carry:
                # a partial CSI may still complete over a laggy connection
                # (dropping it would decode the late final byte as a move
                # key); keep it for one more timeout window, then discard
                stale += 1
                if stale >= 2:
                    carry = b""
            continue
        data = os.read(fd, 64)
        if not data:
            break
        stale = 0
        keys, carry = decode_keys_partial(carry + data)
        for key in keys:
            alive = control.apply_key(key)
            if on_key is not None:
                on_key(key, control.coordinates())
            if not alive:
                return


class KeyThread:
    """TTY listener with main-thread-owned terminal state (context manager).

    ``close()``/``__exit__`` restores the terminal settings even when the
    audio loop finishes on its own or raises — a daemon thread cannot be
    relied on to unwind (its finally is skipped at interpreter shutdown,
    leaving the shell in cbreak/no-echo until ``reset``).
    """

    def __init__(self, control: SourceControl, on_key=None):
        import sys
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._old = termios.tcgetattr(self._fd)
        self._stop = threading.Event()
        tty.setcbreak(self._fd)
        self.thread = threading.Thread(
            target=tty_key_loop, args=(control, self._fd),
            kwargs={"on_key": on_key, "stop": self._stop}, daemon=True,
        )
        self.thread.start()

    def close(self) -> None:
        import termios

        # stop the reader BEFORE restoring the terminal: a still-running
        # loop would keep consuming stdin for the life of the process,
        # eating keystrokes meant for whatever runs after the session
        self._stop.set()
        self.thread.join(timeout=0.5)
        if self._old is not None:
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._old)
            self._old = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_key_thread(control: SourceControl, on_key=None) -> KeyThread | None:
    """Start the TTY listener if stdin is a terminal; None otherwise.

    Callers MUST close() the returned KeyThread (or use it as a context
    manager) so the terminal mode is restored."""
    import sys

    try:
        if not sys.stdin.isatty():
            return None
    except Exception:
        return None
    return KeyThread(control, on_key=on_key)
