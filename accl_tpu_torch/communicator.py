"""Communicator: the rank table of a collective group.

Counterpart of accl_tpu/communicator.py. A rank is a virtual rank on the
one card (a row of every stacked buffer); the exchange-memory layout of
the table is the reference's, word for word.
"""

from __future__ import annotations

import dataclasses

from .constants import MAX_SEG_SIZE


@dataclasses.dataclass
class Rank:
    """One communicator entry. device_index is the rank's row in the
    stacked (world, n) buffers."""

    ip: str = ""
    port: int = 0
    session_id: int = 0xFFFFFFFF
    max_segment_size: int = MAX_SEG_SIZE
    device_index: int = -1
    inbound_seq: int = 0
    outbound_seq: int = 0


class Communicator:
    """A collective group with a dense rank table; `exchmem_words` /
    `from_exchmem_words` serialize it in the firmware layout."""

    def __init__(self, ranks: list[Rank], local_rank: int, exchmem_addr: int = 0):
        if not 0 <= local_rank < len(ranks):
            raise ValueError(f"local rank {local_rank} outside world of {len(ranks)}")
        self.ranks = ranks
        self.local_rank = local_rank
        self.exchmem_addr = exchmem_addr

    @property
    def size(self) -> int:
        return len(self.ranks)

    def prev_rank(self, distance: int = 1) -> int:
        return (self.local_rank - distance) % self.size

    def next_rank(self, distance: int = 1) -> int:
        return (self.local_rank + distance) % self.size

    # one word each of size and local_rank, then per rank: ip, port,
    # inbound_seq, outbound_seq, session, max_seg_size, device_index
    WORDS_PER_RANK = 7

    def exchmem_words(self) -> list[int]:
        words = [self.size, self.local_rank]
        for r in self.ranks:
            words += [
                _pack_ip(r.ip),
                r.port,
                r.inbound_seq,
                r.outbound_seq,
                r.session_id & 0xFFFFFFFF,
                r.max_segment_size,
                r.device_index & 0xFFFFFFFF,
            ]
        return words

    @classmethod
    def from_exchmem_words(cls, words: list[int], exchmem_addr: int = 0):
        size, local_rank = words[0], words[1]
        w = cls.WORDS_PER_RANK
        ranks = []
        for i in range(size):
            ip_w, port, inseq, outseq, sess, seg, dev = words[2 + w * i : 2 + w * (i + 1)]
            if dev == 0xFFFFFFFF:  # sign-restore the -1 "no device" marker
                dev = -1
            ranks.append(
                Rank(
                    ip=_unpack_ip(ip_w),
                    port=port,
                    session_id=sess,
                    max_segment_size=seg,
                    inbound_seq=inseq,
                    outbound_seq=outseq,
                    device_index=dev,
                )
            )
        return cls(ranks, local_rank, exchmem_addr)

    def dump(self) -> str:
        lines = [f"Communicator: size={self.size} local_rank={self.local_rank}"]
        for i, r in enumerate(self.ranks):
            lines.append(
                f"  rank {i}: ip={r.ip or '-'} port={r.port} dev={r.device_index} "
                f"session={r.session_id:#x} seg={r.max_segment_size} "
                f"seq(in={r.inbound_seq},out={r.outbound_seq})"
            )
        return "\n".join(lines)


def _pack_ip(ip: str) -> int:
    if not ip:
        return 0
    parts = [int(p) for p in ip.split(".")]
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


def _unpack_ip(word: int) -> str:
    if word == 0:
        return ""
    return f"{(word >> 24) & 0xFF}.{(word >> 16) & 0xFF}.{(word >> 8) & 0xFF}.{word & 0xFF}"


def generate_ranks(
    count: int, start_port: int = 5500, base_ip: str = "127.0.0.1"
) -> list[Rank]:
    """Local-host rank table generator (accl_network_utils'
    generate_ranks in the reference): rank i on base_ip, port
    start_port + i, session id i, device index i."""
    return [
        Rank(ip=base_ip, port=start_port + i, session_id=i, device_index=i)
        for i in range(count)
    ]
