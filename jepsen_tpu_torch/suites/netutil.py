"""Shared socket plumbing for the hand-rolled wire clients."""

from __future__ import annotations

import socket


def nodelay(sock: socket.socket) -> socket.socket:
    """Disable Nagle: every protocol here is strict request/response,
    where Nagle + delayed ACK otherwise cost ~40ms per round trip (the
    reference's JDBC/DataStax drivers set this themselves)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock
