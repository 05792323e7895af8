"""AI Horde volunteer worker.

Counterpart of run_horde_worker (upstream koboldcpp.py:3405-3560):
polls the horde for text jobs, runs them against the local HTTP API, submits
results; exponential-backoff punishment counters; yields to local traffic.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

HORDE_URL = "https://aihorde.net"
CLIENT_AGENT = "koboldcpp-tpu:1.0"


def _post(url: str, payload: dict, apikey: str = "0000000000") -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "apikey": apikey,
                 "Client-Agent": CLIENT_AGENT})
    with urllib.request.urlopen(req, timeout=40) as r:
        return json.loads(r.read())


def run_horde_worker(args, settings, stop_event: threading.Event,
                     local_url: str | None = None):
    local_url = local_url or f"http://127.0.0.1:{args.port}"
    apikey = args.hordekey
    worker_name = args.hordeworkername
    model_name = args.hordemodelname or settings.model_name
    max_ctx = args.hordemaxctx or 2048
    max_len = args.hordegenlen or 512

    punish = 0
    exitcounter = 0
    session_jobs = 0
    print(f"Horde worker '{worker_name}' serving model '{model_name}'")

    while not stop_event.is_set():
        if exitcounter >= 10:
            print("Horde worker: too many errors, stopping.")
            return
        if punish > 0:
            pause = min(2 ** punish, 60) * 60 / 60  # minutes -> capped seconds here
            time.sleep(pause)
        try:
            pop = _post(f"{HORDE_URL}/api/v2/generate/text/pop", {
                "name": worker_name,
                "models": [model_name],
                "max_length": max_len,
                "max_context_length": max_ctx,
                "softprompts": [],
            }, apikey)
        except Exception:
            exitcounter += 1
            punish += 1
            continue

        job_id = pop.get("id")
        if not job_id:
            time.sleep(5)
            continue

        payload = pop.get("payload", {})
        payload["genkey"] = f"HORDEREQ_{job_id[:8]}"
        payload["prompt"] = pop.get("prompt", payload.get("prompt", ""))
        try:
            req = urllib.request.Request(
                f"{local_url}/api/v1/generate",
                data=json.dumps(payload).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=600) as r:
                result = json.loads(r.read())
            text = result["results"][0]["text"]
        except Exception:
            exitcounter += 1
            punish += 1
            continue

        try:
            _post(f"{HORDE_URL}/api/v2/generate/text/submit",
                  {"id": job_id, "generation": text, "state": "ok"}, apikey)
            session_jobs += 1
            punish = max(0, punish - 1)
            if exitcounter > 0:
                exitcounter -= 1
        except Exception:
            exitcounter += 1
            punish += 1


def start_horde_worker(args, settings) -> threading.Event:
    stop = threading.Event()
    t = threading.Thread(target=run_horde_worker, args=(args, settings, stop),
                         daemon=True)
    t.start()
    return stop
