"""etcd v2 HTTP API client: the verschlimmbesserung five-call surface.

The reference speaks etcd's v2 keys API through verschlimmbesserung
(connect / get / reset! / cas! / swap!, src/jepsen/etcdemo.clj:79-98,
set.clj:13-29) with a 5000 ms timeout (:79). The same surface here, over
a small HTTP/1.1 client on asyncio streams (the standard library only):
one keep-alive connection per client, opened on first use, form-encoded
PUT and POST bodies, query parameters, a 5 s timeout.

  GET /v2/keys/<k>[?quorum=true]            -> value | None (code 100)
  PUT /v2/keys/<k> value=v                  -> reset
  PUT /v2/keys/<k> prevValue=old value=new  -> cas (False on code 101)
  swap(k, fn): get-with-index + prevIndex CAS retry loop
  POST / sorted GET / prevIndex DELETE      -> the in-order-keys queue

Errors here are value-level: a failed connect before any byte was sent
is ConnectionRefused (determinate), anything after a send (a timeout, a
reset or broken pipe, a malformed or cut reply) is Timeout
(indeterminate). The op-level mapping (:fail against :info) lives in the
workloads' clients, as the reference splits verschlimmbesserung from
its Client record.
"""

from __future__ import annotations

import asyncio
import json
import select
from typing import Any, Optional
from urllib.parse import quote, urlencode, urlsplit

from .base import (ClientError, ConnectionRefused, IndeterminateDequeue,
                   NotFound, RetriesExhausted, Timeout)

ETCD_KEY_MISSING = 100   # etcd v2 errorCode for an absent key (:104)
ETCD_CAS_FAILED = 101    # compare failed


class EtcdError(ClientError):
    def __init__(self, code: int, message: str):
        super().__init__(f"etcd error {code}: {message}")
        self.code = code


class _BadReply(Exception):
    """A reply that is not well-formed HTTP/1.1."""


class EtcdClient:
    """One connection to one node's client port (2379,
    support.clj:14-17)."""

    def __init__(self, base_url: str, timeout_s: float = 5.0):
        self.base_url = base_url.rstrip("/")
        u = urlsplit(self.base_url)
        self.host = u.hostname
        self.port = u.port or 80
        self.timeout_s = timeout_s
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    @classmethod
    def connect(cls, node: str, port: int = 2379,
                timeout_s: float = 5.0) -> "EtcdClient":
        return cls(f"http://{node}:{port}", timeout_s=timeout_s)

    async def close(self):
        writer = self._writer
        self._drop()
        if writer is not None:
            try:
                await writer.wait_closed()
            except OSError:
                pass   # the peer had reset it: closed all the same

    def _drop(self) -> None:
        """Close the connection (the socket goes at once: the runner's
        select(2) loop cannot watch a descriptor past 1,024, so none may
        leak across kills and reincarnations)."""
        if self._writer is not None:
            self._writer.close()
        self._reader = self._writer = None

    def _url(self, key: str) -> str:
        return f"{self.base_url}/v2/keys/{key}"

    @staticmethod
    def _raise_for(body: dict):
        code = body.get("errorCode")
        if code == ETCD_KEY_MISSING:
            raise NotFound(body.get("message", "key not found"))
        if code is not None and code != ETCD_CAS_FAILED:
            raise EtcdError(code, body.get("message", ""))

    async def _open(self) -> None:
        """A connection to send on: the open one unless its peer closed
        it (a server that was killed or restarted while it sat idle),
        else a new one. A connect that fails before any byte was sent is
        ConnectionRefused; one that times out is Timeout, since a SYN
        without an answer proves nothing about what the peer got."""
        if self._writer is not None and not (
                self._reader.at_eof() or self._writer.is_closing()
                or self._readable()):
            return
        self._drop()
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.timeout_s)
        except asyncio.TimeoutError as e:
            raise Timeout(f"connect to {self.base_url} timed out") from e
        except OSError as e:
            raise ConnectionRefused(str(e)) from e

    def _readable(self) -> bool:
        """The idle socket has bytes or an end of stream the loop has not
        read yet: a peer that closed it (a kill's FIN arrives before the
        loop's next select), so a request sent on it would fail after the
        send, as an indeterminate Timeout, instead of being refused."""
        poller = select.poll()
        poller.register(self._writer.get_extra_info("socket").fileno(),
                        select.POLLIN)
        return bool(poller.poll(0))

    def _encode(self, method: str, url: str, params: Optional[dict],
                data: Optional[dict]) -> bytes:
        u = urlsplit(url)
        target = quote(u.path) + (f"?{urlencode(params)}" if params else "")
        body = urlencode(data).encode() if data is not None else b""
        head = [f"{method} {target} HTTP/1.1",
                f"Host: {u.netloc}",
                "Accept: */*",
                "Connection: keep-alive"]
        if data is not None:
            head += ["Content-Type: application/x-www-form-urlencoded",
                     f"Content-Length: {len(body)}"]
        return ("\r\n".join(head) + "\r\n\r\n").encode() + body

    async def _read_reply(self) -> tuple[bytes, bool]:
        """(body, whether the server keeps the connection open) of one
        reply: Content-Length, chunked or read to the close."""
        r = self._reader
        status = (await r.readuntil(b"\r\n")).split(b" ", 2)
        if len(status) < 2 or not status[0].startswith(b"HTTP/1."):
            raise _BadReply(f"bad status line {status!r}")
        headers = {}
        while True:
            line = await r.readuntil(b"\r\n")
            if line == b"\r\n":
                break
            name, sep, value = line.decode("latin-1").partition(":")
            if not sep:
                raise _BadReply(f"bad header line {line!r}")
            headers[name.strip().lower()] = value.strip()
        keep = (headers.get("connection", "").lower() != "close"
                and status[0] == b"HTTP/1.1")
        if "chunked" in headers.get("transfer-encoding", "").lower():
            parts = []
            while True:
                size = int((await r.readuntil(b"\r\n")).split(b";")[0], 16)
                if size == 0:
                    while await r.readuntil(b"\r\n") != b"\r\n":
                        pass
                    break
                parts.append(await r.readexactly(size))
                await r.readexactly(2)
            return b"".join(parts), keep
        if "content-length" in headers:
            return await r.readexactly(int(headers["content-length"])), keep
        return await r.read(), False

    async def _request(self, method: str, url: str,
                       params: Optional[dict] = None,
                       data: Optional[dict] = None) -> dict:
        await self._open()
        try:
            self._writer.write(self._encode(method, url, params, data))
            await asyncio.wait_for(self._writer.drain(), self.timeout_s)
            body, keep = await asyncio.wait_for(self._read_reply(),
                                                self.timeout_s)
        except (asyncio.TimeoutError, OSError, asyncio.IncompleteReadError,
                asyncio.LimitOverrunError, ValueError, _BadReply) as e:
            # Bytes may have left: indeterminate. This covers a reused
            # keep-alive socket to a just-killed server, which fails on
            # the send (EPIPE / ECONNRESET).
            self._drop()
            raise Timeout(f"{method} {url}: {type(e).__name__}: {e}") from e
        except BaseException:
            self._drop()
            raise
        if not keep:
            self._drop()
        return json.loads(body)

    # -- the five-call surface ------------------------------------------
    async def get(self, key: str, quorum: bool = False) -> Optional[str]:
        params = {"quorum": "true"} if quorum else {}
        body = await self._request("GET", self._url(key), params=params)
        if body.get("errorCode") == ETCD_KEY_MISSING:
            return None
        self._raise_for(body)
        return body["node"]["value"]

    async def get_with_index(self, key: str,
                             quorum: bool = False) -> tuple[str, int]:
        params = {"quorum": "true"} if quorum else {}
        body = await self._request("GET", self._url(key), params=params)
        self._raise_for(body)
        node = body["node"]
        return node["value"], node["modifiedIndex"]

    async def reset(self, key: str, value: Any) -> None:
        body = await self._request("PUT", self._url(key),
                                   data={"value": str(value)})
        self._raise_for(body)

    async def cas(self, key: str, old: Any, new: Any) -> bool:
        body = await self._request(
            "PUT", self._url(key),
            data={"value": str(new)}, params={"prevValue": str(old)})
        if body.get("errorCode") == ETCD_CAS_FAILED:
            return False
        self._raise_for(body)
        return True

    # -- the queue (etcd v2 atomic in-order keys) ------------------------
    async def enqueue(self, key: str, value: Any) -> None:
        """Append through etcd's in-order-keys recipe: a POST to the
        queue dir creates a node named by its creation index. A timeout
        is indeterminate, as for any write."""
        body = await self._request("POST", self._url(key),
                                   data={"value": str(value)})
        self._raise_for(body)

    async def dequeue(self, key: str) -> str:
        """Claim the queue's head: quorum-read the dir in creation order,
        compare-and-delete its first node (prevIndex); a claim lost to
        another consumer retries on the next head. Once the
        compare-and-delete was sent, a timeout is indeterminate forever
        (it may commit later), so it raises IndeterminateDequeue with the
        claimed value; a timeout before any claim stays a Timeout."""
        for _ in range(64):
            body = await self._request(
                "GET", self._url(key),
                params={"recursive": "true", "sorted": "true",
                        "quorum": "true"})
            if body.get("errorCode") == ETCD_KEY_MISSING:
                raise NotFound(key)
            self._raise_for(body)
            nodes = body.get("node", {}).get("nodes") or []
            if not nodes:
                raise NotFound(key)
            head = nodes[0]
            value, idx = head["value"], head["modifiedIndex"]
            node_url = f"{self.base_url}/v2/keys{head['key']}"
            try:
                del_body = await self._request(
                    "DELETE", node_url, params={"prevIndex": str(idx)})
            except Timeout as e:
                raise IndeterminateDequeue(value) from e
            if del_body.get("errorCode") in (ETCD_KEY_MISSING,
                                             ETCD_CAS_FAILED):
                continue   # another consumer claimed it
            self._raise_for(del_body)
            return value
        # Every claim was lost determinately (the node missing or newer);
        # an indeterminate one raised above.
        raise RetriesExhausted(
            "dequeue retry budget exhausted: 64 determinate claim losses")

    async def swap(self, key: str, fn) -> str:
        """Atomic read-modify-write through prevIndex CAS retries, the
        client-side loop of verschlimmbesserung's swap! (set.clj:26-31)."""
        for _ in range(64):
            cur, idx = await self.get_with_index(key, quorum=True)
            # str() before returning: the store holds strings, so the
            # value reported must be the one a later get() sees.
            new = str(fn(cur))
            body = await self._request(
                "PUT", self._url(key),
                data={"value": new}, params={"prevIndex": str(idx)})
            if body.get("errorCode") == ETCD_CAS_FAILED:
                continue
            self._raise_for(body)
            return new
        raise RetriesExhausted(
            "swap retry budget exhausted: 64 determinate CAS failures")


def etcd_conn_factory(port: Optional[int] = None, timeout_s: float = 5.0):
    """Per-node connections. port=None resolves each node's client port
    through db/etcd.py (its default, environment override or port map);
    a port pins every node to it."""
    def factory(test, node):
        if port is None:
            from ..db.etcd import client_port_for

            return EtcdClient.connect(node, port=client_port_for(node),
                                      timeout_s=timeout_s)
        return EtcdClient.connect(node, port=port, timeout_s=timeout_s)
    return factory
