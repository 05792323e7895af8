"""Cloudflare quick-tunnel for remote access (--remotetunnel).

Counterpart of setuptunnel (upstream koboldcpp.py:3611-3690): spawn
`cloudflared tunnel --url http://localhost:<port>`, scrape the generated
trycloudflare.com URL from its stderr, print the API endpoints. Downloads the
binary if absent (skipped gracefully in offline environments).
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import threading

_URL_RE = re.compile(r"https://[\w\.-]+\.trycloudflare\.com")
_RELEASE = ("https://github.com/cloudflare/cloudflared/releases/latest/"
            "download/cloudflared-linux-amd64")


def find_cloudflared() -> str | None:
    """Locate a usable cloudflared binary (PATH, cwd) or try to download."""
    path = shutil.which("cloudflared")
    if path:
        return path
    for cand in ("./cloudflared", "./cloudflared-linux-amd64"):
        if os.path.exists(cand) and os.path.getsize(cand) > 1_000_000:
            return cand
    try:
        import urllib.request

        print("Downloading cloudflared...")
        urllib.request.urlretrieve(_RELEASE, "cloudflared-linux-amd64")
        os.chmod("cloudflared-linux-amd64", 0o755)
        return "./cloudflared-linux-amd64"
    except Exception as e:  # offline / blocked egress
        print(f"Could not obtain cloudflared ({e}); remote tunnel disabled.")
        return None


class Tunnel:
    """Runs cloudflared in the background; .url is set once scraped."""

    def __init__(self, port: int, binary: str | None = None, https: bool = False):
        self.port = port
        self.binary = binary
        self.https = https
        self.url: str | None = None
        self.proc: subprocess.Popen | None = None
        self._ready = threading.Event()

    def start(self, timeout: float = 20.0) -> str | None:
        binary = self.binary or find_cloudflared()
        if binary is None:
            return None
        scheme = "https" if self.https else "http"
        self.proc = subprocess.Popen(
            [binary, "tunnel", "--url", f"{scheme}://localhost:{self.port}"],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, encoding="utf-8")
        t = threading.Thread(target=self._reader, daemon=True)
        t.start()
        if not self._ready.wait(timeout):
            print("Error: could not create cloudflare tunnel (timed out)")
            return None
        return self.url

    def _reader(self):
        # cloudflared logs the assigned URL to stderr
        assert self.proc is not None and self.proc.stderr is not None
        for line in self.proc.stderr:
            m = _URL_RE.search(line)
            if m:
                self.url = m.group(0)
                print(f"Your remote Kobold API can be found at {self.url}/api")
                print(f"Your remote OpenAI Compatible API can be found at {self.url}/v1")
                print(f"Your remote tunnel is ready, please connect to {self.url}")
                self._ready.set()
                return

    def stop(self):
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
            self.proc = None
