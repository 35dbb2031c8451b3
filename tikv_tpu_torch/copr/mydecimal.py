"""Wide MySQL DECIMAL: exact 81-digit fixed point + memcomparable binary codec.

The port's own copy of ``tikv_tpu/copr/mydecimal.py``; the row-v2 decoder
needs it.

Re-expression of ``tidb_query_datatype/src/codec/mysql/decimal.rs``.  The
reference stores digits as nine base-10^9 words (WORD_BUF_LEN=9,
DIGITS_PER_WORD=9 → 81-digit capacity, MAX_FRACTION=30) and hand-rolls the
carry chains in Rust.  Here the host-side representation is a Python
arbitrary-precision integer (``unscaled``) plus a fractional-digit count —
exact, branch-free, and trivially convertible to the framework's
device-resident form.

Split:

* **Device path** stays scaled-int64 (`datatypes.Column` DECIMAL) — decimals
  that fit 18 digits ride int64 lanes unchanged.
* **Host path** (this module) covers the full 81-digit envelope for parsing,
  row-format v2, and the memcomparable binary codec; `to_i64_scaled` bridges
  back to the device form when precision allows.

Binary format parity (``decimal.rs:124-178`` layout constants): digits are
grouped into base-10^9 words of 4 bytes, leading/trailing partial groups use
DIG_2_BYTES, the first byte's MSB is flipped, and negative values are
bitwise-inverted — so ``memcmp`` order equals numeric order, which is what
the reference relies on for index keys.
"""

from __future__ import annotations

WORD_BUF_LEN = 9
DIGITS_PER_WORD = 9
MAX_DIGITS = WORD_BUF_LEN * DIGITS_PER_WORD  # 81
MAX_FRACTION = 30
DIV_FRAC_INCR = 4
# bytes needed to hold 0..9 leftover decimal digits (decimal.rs DIG_2_BYTES)
_DIG_2_BYTES = (0, 1, 1, 2, 2, 3, 3, 4, 4, 4)

# rounding modes (decimal.rs RoundMode; "HalfEven" is MySQL's
# round-half-away-from-zero despite the name)
HALF_EVEN = "half_even"
TRUNCATE = "truncate"
CEILING = "ceiling"


class DecimalOverflow(Exception):
    """Integer part exceeds the 81-digit word buffer."""


class MyDecimal:
    """Immutable exact decimal: ``unscaled * 10^-frac``.

    ``unscaled`` carries the sign (``-0`` has no distinct representation —
    MySQL normalizes it to 0 and Python ints do the same).  ``frac`` ∈ [0, 30].
    """

    __slots__ = ("unscaled", "frac")

    def __init__(self, unscaled: int, frac: int):
        if frac < 0 or frac > MAX_FRACTION:
            raise ValueError(f"frac {frac} out of range")
        self.unscaled = unscaled
        self.frac = frac
        if self.int_digits() + frac > MAX_DIGITS:
            raise DecimalOverflow(f"{self!r} exceeds {MAX_DIGITS} digits")

    # ------------------------------------------------------------- factories
    @classmethod
    def from_int(cls, v: int) -> "MyDecimal":
        return cls(v, 0)

    @classmethod
    def from_str(cls, s: str) -> "MyDecimal":
        """Parse like MySQL: optional sign, digits, '.', digits, exponent."""
        s = s.strip()
        if not s:
            raise ValueError("empty decimal string")
        neg = False
        i = 0
        if s[i] in "+-":
            neg = s[i] == "-"
            i += 1
        int_part = frac_part = ""
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        int_part = s[i:j]
        if j < len(s) and s[j] == ".":
            k = j + 1
            while k < len(s) and s[k].isdigit():
                k += 1
            frac_part = s[j + 1 : k]
            j = k
        exp = 0
        if j < len(s) and s[j] in "eE":
            exp = int(s[j + 1 :])
            j = len(s)
        if j != len(s):
            # MySQL truncates trailing garbage with a warning
            pass
        if not int_part and not frac_part:
            raise ValueError(f"bad decimal string {s!r}")
        digits = (int_part + frac_part) or "0"
        frac = len(frac_part) - exp
        unscaled = int(digits)
        if frac < 0:
            unscaled *= 10 ** (-frac)
            frac = 0
        if frac > MAX_FRACTION:
            # round the tail off at 30 fractional digits
            drop = frac - MAX_FRACTION
            unscaled = _round_div(unscaled, 10**drop)
            frac = MAX_FRACTION
        if neg:
            unscaled = -unscaled
        if _int_digits(unscaled, frac) + frac > MAX_DIGITS:
            raise DecimalOverflow(s)
        return cls(unscaled, frac)

    @classmethod
    def from_f64(cls, v: float, frac: int | None = None) -> "MyDecimal":
        if frac is None:
            d = cls.from_str(repr(v))
        else:
            d = cls.from_str(f"{v:.{min(frac, MAX_FRACTION)}f}")
        return d

    @classmethod
    def from_i64_scaled(cls, scaled: int, frac: int) -> "MyDecimal":
        """Lift the framework's device representation (int64 * 10^-frac)."""
        return cls(scaled, frac)

    @classmethod
    def zero(cls, frac: int = 0) -> "MyDecimal":
        return cls(0, frac)

    @classmethod
    def max_value(cls, prec: int, frac: int) -> "MyDecimal":
        return cls(10**prec - 1, frac)

    # ------------------------------------------------------------ inspection
    def int_digits(self) -> int:
        return _int_digits(self.unscaled, self.frac)

    @property
    def precision(self) -> int:
        return self.int_digits() + self.frac

    def is_negative(self) -> bool:
        return self.unscaled < 0

    def is_zero(self) -> bool:
        return self.unscaled == 0

    def to_string(self) -> str:
        mag = abs(self.unscaled)
        sign = "-" if self.unscaled < 0 else ""
        if self.frac == 0:
            return f"{sign}{mag}"
        q, r = divmod(mag, 10**self.frac)
        return f"{sign}{q}.{r:0{self.frac}d}"

    __str__ = to_string

    def __repr__(self):
        return f"MyDecimal({self.to_string()!r})"

    def to_f64(self) -> float:
        return self.unscaled / (10**self.frac)

    def to_int(self, mode: str = HALF_EVEN) -> int:
        return self.round(0, mode).unscaled

    def to_i64_scaled(self) -> tuple[int, int]:
        """(scaled int64, frac) for the device fast path; raises if too wide."""
        if not (-(2**63) <= self.unscaled < 2**63):
            raise DecimalOverflow("does not fit the device int64 form")
        return self.unscaled, self.frac

    # ------------------------------------------------------------ comparison
    def _cmp_key(self) -> int:
        # compare at a common scale without materializing strings
        return self.unscaled * 10 ** (MAX_FRACTION - self.frac)

    def __eq__(self, other):
        return isinstance(other, MyDecimal) and self._cmp_key() == other._cmp_key()

    def __lt__(self, other):
        if not isinstance(other, MyDecimal):
            return NotImplemented
        return self._cmp_key() < other._cmp_key()

    def __le__(self, other):
        if not isinstance(other, MyDecimal):
            return NotImplemented
        return self._cmp_key() <= other._cmp_key()

    def __hash__(self):
        return hash(self._cmp_key())

    # ------------------------------------------------------------ arithmetic
    def round(self, frac: int, mode: str = HALF_EVEN) -> "MyDecimal":
        """Round to ``frac`` fractional digits (decimal.rs round_with_word_buf_len).

        ``frac`` may be negative (rounds into the integer part, frac_cnt
        becomes 0 like the reference)."""
        target = min(frac, MAX_FRACTION)
        if target >= self.frac:
            return MyDecimal(self.unscaled * 10 ** (target - self.frac), target)
        drop = self.frac - target
        base = 10**drop
        if mode == TRUNCATE:
            q = abs(self.unscaled) // base
        elif mode == CEILING:
            if self.unscaled >= 0:
                q = -((-self.unscaled) // base)  # ceil for positives
            else:
                q = abs(self.unscaled) // base  # toward zero for negatives
        else:  # HALF_EVEN == MySQL round-half-away-from-zero
            q = _round_div(abs(self.unscaled), base)
        if self.unscaled < 0:
            q = -q
        if target < 0:
            q *= 10 ** (-target)
            target = 0
        return MyDecimal(q, target)

    def shift(self, by: int) -> "MyDecimal":
        """Multiply by 10^by (decimal.rs shift); adjusts frac first."""
        if by == 0:
            return self
        if by > 0:
            take = min(by, self.frac)
            d = MyDecimal(self.unscaled, self.frac - take)
            rest = by - take
            if rest:
                d = MyDecimal(d.unscaled * 10**rest, d.frac)
            return d
        add = min(-by, MAX_FRACTION - self.frac)
        d = MyDecimal(self.unscaled, self.frac + add)
        rest = -by - add
        if rest:
            # frac is already at MAX_FRACTION: low digits genuinely fall off
            mag = abs(d.unscaled) // 10**rest
            d = MyDecimal(-mag if d.unscaled < 0 else mag, d.frac)
        return d

    def _align(self, other: "MyDecimal") -> tuple[int, int, int]:
        frac = max(self.frac, other.frac)
        a = self.unscaled * 10 ** (frac - self.frac)
        b = other.unscaled * 10 ** (frac - other.frac)
        return a, b, frac

    def __neg__(self):
        return MyDecimal(-self.unscaled, self.frac)

    def __abs__(self):
        return MyDecimal(abs(self.unscaled), self.frac)

    def __add__(self, other: "MyDecimal") -> "MyDecimal":
        a, b, frac = self._align(other)
        return _clamped(a + b, frac)

    def __sub__(self, other: "MyDecimal") -> "MyDecimal":
        a, b, frac = self._align(other)
        return _clamped(a - b, frac)

    def __mul__(self, other: "MyDecimal") -> "MyDecimal":
        raw = self.unscaled * other.unscaled
        frac = self.frac + other.frac
        if frac > MAX_FRACTION:
            # MySQL truncates (not rounds) excess multiplication scale
            mag = abs(raw) // 10 ** (frac - MAX_FRACTION)
            raw = -mag if raw < 0 else mag
            frac = MAX_FRACTION
        return _clamped(raw, frac)

    def div(self, other: "MyDecimal", frac_incr: int = DIV_FRAC_INCR) -> "MyDecimal | None":
        """Division; None on division by zero (decimal.rs do_div_mod)."""
        if other.is_zero():
            return None
        frac = min(self.frac + frac_incr, MAX_FRACTION)
        # numerator scaled so that quotient has `frac` fractional digits
        num = self.unscaled * 10 ** (frac + other.frac - self.frac)
        q = _round_div(abs(num), abs(other.unscaled))
        if (num < 0) != (other.unscaled < 0):
            q = -q
        return _clamped(q, frac)

    __truediv__ = div

    def __mod__(self, other: "MyDecimal") -> "MyDecimal | None":
        if other.is_zero():
            return None
        a, b, frac = self._align(other)
        r = abs(a) % abs(b)
        if a < 0:
            r = -r
        return MyDecimal(r, frac)

    # ---------------------------------------------------------- binary codec
    def encode_bin(self, prec: int, frac: int) -> bytes:
        """MySQL/TiKV binary decimal (decimal.rs write_bin): memcomparable."""
        if frac > prec:
            raise ValueError("frac > prec")
        try:
            d = self.round(frac, HALF_EVEN)
        except DecimalOverflow:
            # widening the scale overran the 81-digit buffer: the value can't
            # fit (prec, frac) anyway — clamp to the max representable
            mag = 10**prec - 1
            d = MyDecimal(-mag if self.unscaled < 0 else mag, frac)
        int_cnt = prec - frac
        mag = abs(d.unscaled)
        ip, fp = divmod(mag, 10**frac) if frac else (mag, 0)
        if ip and _digits(ip) > int_cnt:
            # overflow: clamp to the max representable magnitude
            ip = 10**int_cnt - 1
            fp = 10**frac - 1 if frac else 0
        neg = d.unscaled < 0

        out = bytearray()
        # integer part: leading partial group then full base-10^9 words
        int_full, int_left = divmod(int_cnt, DIGITS_PER_WORD)
        words = []
        rem = ip
        for _ in range(int_full):
            rem, w = divmod(rem, 10**DIGITS_PER_WORD)
            words.append(w)
        lead = rem
        if int_left:
            out += int(lead).to_bytes(_DIG_2_BYTES[int_left], "big")
        for w in reversed(words):
            out += int(w).to_bytes(4, "big")
        # fractional part: full words then trailing partial group
        frac_full, frac_left = divmod(frac, DIGITS_PER_WORD)
        fdigits = f"{fp:0{frac}d}" if frac else ""
        pos = 0
        for _ in range(frac_full):
            out += int(fdigits[pos : pos + DIGITS_PER_WORD]).to_bytes(4, "big")
            pos += DIGITS_PER_WORD
        if frac_left:
            out += int(fdigits[pos:]).to_bytes(_DIG_2_BYTES[frac_left], "big")

        if not out:
            out = bytearray(1)
        out[0] ^= 0x80
        if neg:
            out = bytearray(b ^ 0xFF for b in out)
        return bytes(out)

    @classmethod
    def decode_bin(cls, data: bytes, prec: int, frac: int) -> tuple["MyDecimal", int]:
        """Inverse of encode_bin; returns (decimal, bytes_consumed)."""
        int_cnt = prec - frac
        int_full, int_left = divmod(int_cnt, DIGITS_PER_WORD)
        frac_full, frac_left = divmod(frac, DIGITS_PER_WORD)
        size = (
            int_full * 4
            + _DIG_2_BYTES[int_left]
            + frac_full * 4
            + _DIG_2_BYTES[frac_left]
        )
        buf = bytearray(data[:size])
        if len(buf) < size:
            raise ValueError("decimal bin truncated")
        neg = not (buf[0] & 0x80)
        if neg:
            buf = bytearray(b ^ 0xFF for b in buf)
        buf[0] ^= 0x80
        pos = 0
        ip = 0
        if int_left:
            n = _DIG_2_BYTES[int_left]
            ip = int.from_bytes(buf[pos : pos + n], "big")
            pos += n
        for _ in range(int_full):
            ip = ip * 10**DIGITS_PER_WORD + int.from_bytes(buf[pos : pos + 4], "big")
            pos += 4
        fp = 0
        for _ in range(frac_full):
            fp = fp * 10**DIGITS_PER_WORD + int.from_bytes(buf[pos : pos + 4], "big")
            pos += 4
        if frac_left:
            n = _DIG_2_BYTES[frac_left]
            fp = fp * 10**frac_left + int.from_bytes(buf[pos : pos + n], "big")
            pos += n
        unscaled = ip * 10**frac + fp
        if neg:
            unscaled = -unscaled
        return cls(unscaled, frac), size

    @staticmethod
    def bin_size(prec: int, frac: int) -> int:
        int_cnt = prec - frac
        return (
            (int_cnt // DIGITS_PER_WORD) * 4
            + _DIG_2_BYTES[int_cnt % DIGITS_PER_WORD]
            + (frac // DIGITS_PER_WORD) * 4
            + _DIG_2_BYTES[frac % DIGITS_PER_WORD]
        )


def _digits(v: int) -> int:
    return len(str(abs(v))) if v else 1


def _int_digits(unscaled: int, frac: int) -> int:
    mag = abs(unscaled)
    ip = mag // 10**frac
    return _digits(ip) if ip else 1


def _round_div(num: int, den: int) -> int:
    """Round-half-away-from-zero division of non-negative ints."""
    return (num + den // 2) // den


def _clamped(unscaled: int, frac: int) -> MyDecimal:
    """Clamp the integer part into the 81-digit buffer (Res::Overflow)."""
    if _int_digits(unscaled, frac) + frac > MAX_DIGITS:
        limit = 10 ** (MAX_DIGITS) - 1
        mag = min(abs(unscaled), limit)
        unscaled = -mag if unscaled < 0 else mag
    return MyDecimal(unscaled, frac)
