# Verbatim copy of datafusion_tpu/models/clickbench/datagen.py; host-only, kept in step with the original.
"""Synthetic ClickBench `hits` table.

The real ClickBench dataset (100M-row web-analytics hits, reference harness:
/root/reference/benchmarks/src/clickbench.rs + queries/clickbench/) is not
available offline; this generator produces a schema-compatible table with the
columns the 43 queries touch, with skewed (Zipf-ish) key distributions --
the workload's defining property (SURVEY.md §6 'Skewed keys')."""
from __future__ import annotations

import numpy as np

from ...common import types as T
from ...data.table import Table

START = int(np.datetime64("2013-07-01", "D").astype(np.int32))
START_TS = int(np.datetime64("2013-07-01", "us").astype(np.int64))


def _zipf_ids(rng, n, domain, a=1.3):
    z = rng.zipf(a, n)
    return (z % domain).astype(np.int64)


def generate_hits(n_rows: int = 100_000, seed: int = 7) -> Table:
    rng = np.random.default_rng(seed)
    n = n_rows

    user_id = _zipf_ids(rng, n, max(n // 3, 10)) * 1000 + 7
    counter_id = _zipf_ids(rng, n, 6000).astype(np.int64)
    region_id = _zipf_ids(rng, n, 200)
    event_date = START + rng.integers(0, 31, n).astype(np.int32)
    event_time = START_TS + rng.integers(0, 31 * 86_400, n).astype(np.int64) * 1_000_000

    phrases = np.array(
        ["", "", "", "weather today", "cat pictures", "news", "google", "python",
         "карманный компьютер", "holiday deals", "pizza near me", "cheap flights"],
        dtype=object)
    search_phrase = phrases[rng.integers(0, len(phrases), n)]
    titles = np.array([f"Page Title {i}" for i in range(500)], dtype=object)
    urls = np.array([f"http://example.com/p{i % 1000}/q{i}" for i in range(2000)], dtype=object)
    referers = np.array([""] * 3 + [f"http://ref{i}.example.org/path" for i in range(300)], dtype=object)
    ua = rng.integers(1, 90, n).astype(np.int64)
    os_id = _zipf_ids(rng, n, 80) + 1
    mobile_phone_model = np.array(["", "iPhone", "Galaxy", "Pixel", ""], dtype=object)[
        rng.integers(0, 5, n)]

    data = {
        "WatchID": rng.integers(1, 2**62, n).astype(np.int64),
        "JavaEnable": rng.integers(0, 2, n).astype(np.int64),
        "Title": titles[_zipf_ids(rng, n, 500)],
        "GoodEvent": np.ones(n, dtype=np.int64),
        "EventTime": event_time,
        "EventDate": event_date,
        "CounterID": counter_id,
        "ClientIP": rng.integers(0, 2**31, n).astype(np.int64),
        "RegionID": region_id,
        "UserID": user_id,
        "CounterClass": rng.integers(0, 3, n).astype(np.int64),
        "OS": os_id,
        "UserAgent": ua,
        "URL": urls[_zipf_ids(rng, n, 2000)],
        "Referer": referers[rng.integers(0, len(referers), n)],
        "IsRefresh": (rng.random(n) < 0.1).astype(np.int64),
        "RefererCategoryID": _zipf_ids(rng, n, 100),
        "RefererRegionID": _zipf_ids(rng, n, 200),
        "URLCategoryID": _zipf_ids(rng, n, 100),
        "URLRegionID": _zipf_ids(rng, n, 200),
        "ResolutionWidth": rng.choice([0, 1366, 1920, 1024, 768, 414], n).astype(np.int64),
        "ResolutionHeight": rng.choice([0, 768, 1080, 640], n).astype(np.int64),
        "UserAgentMajor": rng.integers(0, 30, n).astype(np.int64),
        "UserAgentMinor": np.array([""] * n, dtype=object),
        "MobilePhone": rng.integers(0, 5, n).astype(np.int64),
        "MobilePhoneModel": mobile_phone_model,
        "SearchPhrase": search_phrase,
        "SearchEngineID": _zipf_ids(rng, n, 20),
        "AdvEngineID": np.where(rng.random(n) < 0.95, 0, rng.integers(1, 20, n)).astype(np.int64),
        "IsArtifical": (rng.random(n) < 0.05).astype(np.int64),
        "WindowClientWidth": rng.choice([0, 1350, 1900, 1000], n).astype(np.int64),
        "WindowClientHeight": rng.choice([0, 700, 1000, 600], n).astype(np.int64),
        "SendTiming": rng.integers(0, 30000, n).astype(np.int64),
        "DNSTiming": rng.integers(0, 1000, n).astype(np.int64),
        "ConnectTiming": rng.integers(0, 1000, n).astype(np.int64),
        "ResponseStartTiming": rng.integers(0, 5000, n).astype(np.int64),
        "ResponseEndTiming": rng.integers(0, 10000, n).astype(np.int64),
        "FetchTiming": rng.integers(0, 10000, n).astype(np.int64),
        "SocialSourceNetworkID": _zipf_ids(rng, n, 10),
        "ParamPrice": rng.integers(0, 1000, n).astype(np.int64),
        "ParamOrderID": np.array(["" if x else f"O{rng.integers(0, 1_000_00)}"
                                  for x in (rng.random(n) < 0.9)], dtype=object),
        "ParamCurrency": np.array(["", "RUB", "USD", "EUR"], dtype=object)[rng.integers(0, 4, n)],
        "ParamCurrencyID": _zipf_ids(rng, n, 4),
        "OpenstatServiceName": np.array([""] * n, dtype=object),
        "OpenstatCampaignID": np.array([""] * n, dtype=object),
        "OpenstatAdID": np.array([""] * n, dtype=object),
        "OpenstatSourceID": np.array([""] * n, dtype=object),
        "UTMSource": np.array(["", "newsletter", "ads"], dtype=object)[rng.integers(0, 3, n)],
        "UTMMedium": np.array([""] * n, dtype=object),
        "UTMCampaign": np.array([""] * n, dtype=object),
        "UTMContent": np.array([""] * n, dtype=object),
        "UTMTerm": np.array([""] * n, dtype=object),
        "FromTag": np.array([""] * n, dtype=object),
        "HasGCLID": rng.integers(0, 2, n).astype(np.int64),
        "RefererHash": rng.integers(0, 2**62, n).astype(np.int64),
        "URLHash": rng.integers(0, 2**62, n).astype(np.int64),
        "CLID": _zipf_ids(rng, n, 1000),
        "TraficSourceID": rng.integers(-1, 10, n).astype(np.int64),
        "IsMobile": rng.integers(0, 2, n).astype(np.int64),
        "DontCountHits": (rng.random(n) < 0.05).astype(np.int64),
        "IsLink": (rng.random(n) < 0.1).astype(np.int64),
        "IsDownload": (rng.random(n) < 0.02).astype(np.int64),
        "IsNotBounce": rng.integers(0, 2, n).astype(np.int64),
    }
    from ..tpch.datagen import _decimal_table

    return _decimal_table(data, dates=["EventDate"], timestamps=["EventTime"])


def register_hits(ctx, n_rows: int = 100_000, seed: int = 7) -> None:
    ctx.register_table("hits", generate_hits(n_rows, seed))
