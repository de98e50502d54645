"""Notification hooks: dag/task lifecycle events to external sinks.

The reference's ancestry ships chat-bot notifications on task completion;
here the sink is pluggable (the TPU-VM fleet runs with no general egress,
so a shell-command sink and an append-to-file sink are first-class, with a
webhook sink for networks that allow it):

- ``file``:    append one JSON line per event to a path — cheap audit log;
- ``command``: pipe the event JSON to a shell command's stdin (wire up
  Slack CLIs, pagers, anything) — non-zero exit is logged, never raised;
- ``webhook``: POST the event JSON to a URL.

Events carry ``{"event": "dag_finished"|"task_failed", ...detail}``.  The
Supervisor fires them; notifier failures must never take the scheduler
down, so every send is wrapped.
"""

from __future__ import annotations

import json
import subprocess
import time
import urllib.request
from typing import Any, Dict, List, Optional

from mlcomp_tpu_torch.utils.registry import Registry

NOTIFIERS: Registry = Registry("notifiers")


class Notifier:
    def send(self, event: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError


@NOTIFIERS.register("file")
class FileNotifier(Notifier):
    def __init__(self, path: str, **_):
        self.path = path

    def send(self, event: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(event) + "\n")


@NOTIFIERS.register("command")
class CommandNotifier(Notifier):
    def __init__(self, cmd: str, timeout_s: float = 10.0, **_):
        self.cmd = cmd
        self.timeout_s = timeout_s

    def send(self, event: Dict[str, Any]) -> None:
        subprocess.run(
            self.cmd,
            shell=True,
            input=json.dumps(event).encode(),
            timeout=self.timeout_s,
            check=True,
            capture_output=True,
        )


@NOTIFIERS.register("webhook")
class WebhookNotifier(Notifier):
    def __init__(self, url: str, timeout_s: float = 10.0, **_):
        self.url = url
        self.timeout_s = timeout_s

    def send(self, event: Dict[str, Any]) -> None:
        req = urllib.request.Request(
            self.url,
            data=json.dumps(event).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self.timeout_s).read()


@NOTIFIERS.register("telegram")
class TelegramNotifier(Notifier):
    """Telegram Bot API sink (the upstream reference's ancestry ships a
    telegram bot for task notifications).  Needs a bot ``token`` and a
    ``chat_id``; on zero-egress fleets the send fails and ``notify_all``
    logs-and-swallows it like any other sink error."""

    def __init__(self, token: str, chat_id: str, timeout_s: float = 10.0, **_):
        if not token or not chat_id:
            raise ValueError("telegram notifier needs both token and chat_id")
        self.url = f"https://api.telegram.org/bot{token}/sendMessage"
        self.chat_id = str(chat_id)
        self.timeout_s = timeout_s

    def send(self, event: Dict[str, Any]) -> None:
        detail = {k: v for k, v in event.items() if k not in ("event", "ts")}
        text = f"[{event['event']}] {json.dumps(detail, default=str)}"
        # Bot API hard limit; an over-long traceback must not cost the
        # notification itself (400 "message is too long")
        text = text[:4096]
        req = urllib.request.Request(
            self.url,
            data=json.dumps({"chat_id": self.chat_id, "text": text}).encode(),
            headers={"Content-Type": "application/json"},
        )
        urllib.request.urlopen(req, timeout=self.timeout_s).read()


def create_notifiers(cfgs: Optional[List[Dict[str, Any]]]) -> List[Notifier]:
    """[{type: file, path: ...}, {type: command, cmd: ...}] → notifiers."""
    out: List[Notifier] = []
    for cfg in cfgs or []:
        cfg = dict(cfg)
        kind = cfg.pop("type")
        out.append(NOTIFIERS.create(kind, **cfg))
    return out


def notify_all(
    notifiers: List[Notifier],
    event: str,
    on_error=None,
    **detail,
) -> Dict[str, Any]:
    """Send to every sink; a failing sink is reported, never raised."""
    payload = {"event": event, "ts": time.time(), **detail}
    for n in notifiers:
        try:
            n.send(payload)
        except Exception as e:
            if on_error is not None:
                on_error(f"notifier {type(n).__name__} failed: {e}")
    return payload
