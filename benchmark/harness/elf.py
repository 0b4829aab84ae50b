"""The function names a shared library defines, read from its ELF symbol
tables (``.symtab`` and ``.dynsym``), with no tool beyond the standard
library. The benchmark reads the program's kernel library this way, so a
kernel that a later change adds is counted as the library's without an
edit here."""

from __future__ import annotations

import re
import struct
from pathlib import Path
from typing import Set

_STT_FUNC = 2


def function_symbols(path: Path) -> Set[str]:
    """Every function a 64-bit little-endian ELF file defines."""
    data = Path(path).read_bytes()
    if data[:4] != b"\x7fELF" or data[4] != 2 or data[5] != 1:
        raise ValueError(f"{path}: not a 64-bit little-endian ELF file")
    shoff, = struct.unpack_from("<Q", data, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", data, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", data, shoff + i * shentsize) for i in range(shnum)]
    names = set()
    for sh in sections:
        sh_type, sh_offset, sh_size, sh_link, sh_entsize = sh[1], sh[4], sh[5], sh[6], sh[9]
        if sh_type not in (2, 11) or not sh_entsize:  # SHT_SYMTAB, SHT_DYNSYM
            continue
        strtab = sections[sh_link]
        str_off = strtab[4]
        for k in range(sh_size // sh_entsize):
            st_name, st_info, _, st_shndx = struct.unpack_from("<IBBH", data, sh_offset + k * sh_entsize)
            if st_info & 0xF != _STT_FUNC or not st_name or st_shndx == 0:  # defined functions
                continue
            end = data.index(b"\0", str_off + st_name)
            names.add(data[str_off + st_name : end].decode("ascii", "replace"))
    return names


_SOURCE_NAME = re.compile(r"(\d+)")


def mangled_identifiers(symbol: str) -> Set[str]:
    """The source names (identifiers) in an Itanium-mangled symbol, or the
    symbol itself when it is not mangled: ``_ZN12_GLOBAL__N_16kernelIL...``
    gives ``{"_GLOBAL__N_1", "kernel", ...}``."""
    if not symbol.startswith("_Z"):
        return {symbol}
    out, i = set(), 2
    while i < len(symbol):
        m = _SOURCE_NAME.match(symbol, i)
        if m is None:
            i += 1
            continue
        n = int(m.group(1))
        start = m.end()
        ident = symbol[start : start + n]
        if n and len(ident) == n and re.fullmatch(r"[A-Za-z_]\w*", ident):
            out.add(ident)
            i = start + n
        else:
            i = m.end()
    return out


def kernel_base_name(name: str) -> str:
    """The function's own identifier in a demangled kernel name as a
    profiler trace gives it: ``void ns::conv_kernel<64, 32>(Params)`` gives
    ``conv_kernel``."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    depth, cut = 0, len(s)
    for k, ch in enumerate(s):  # the qualified name ends at the first top-level < or (
        if ch in "<(" and depth == 0:
            cut = k
            break
    s = s[:cut].strip()
    return s.rsplit("::", 1)[-1]


def library_identifiers(paths) -> Set[str]:
    """Every identifier named in the function symbols of the libraries."""
    out: Set[str] = set()
    for p in paths:
        for sym in function_symbols(p):
            out |= mangled_identifiers(sym)
    return out
