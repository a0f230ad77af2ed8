"""filo-cli equivalent: dataset ops, ingestion, PromQL queries, shard status.

Reference: cli/src/main/scala/filodb.cli/CliMain.scala:26-90 (importcsv, promql
queries against a cluster, labelValues, shard status, schema validation).

Port of ``filodb_tpu/cli.py``; ``python -m filodb_tpu_torch.cli`` is the
entry point. ``serve`` starts a :class:`~filodb_tpu_torch.standalone.
FiloServer` from ``--config`` (the reference's ``serve`` built a bare
memstore and HTTP server and ignored the config's ingest and cluster
keys), with the flags layered over the file; ``--device`` picks where the
shards live (``cuda`` by default, raising without a card; the CPU tests pass
``cpu``). The broker holds no tensors and takes no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="filo-cli", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="start a standalone server")
    s.add_argument("--config", default=None, help="server config json")
    # unset flags leave the config (whose defaults are these) alone
    s.add_argument("--port", type=int, default=None, help="default 8080")
    s.add_argument("--dataset", default=None, help="default prometheus")
    s.add_argument("--schema", default=None, help="default gauge")
    s.add_argument("--shards", type=int, default=None, help="default 1")
    s.add_argument("--data-dir", default=None, help="enable durable chunk store")
    s.add_argument("--seed-data", action="store_true",
                   help="ingest synthetic demo data on startup")
    s.add_argument("--device", default=None,
                   help="where the shards live: cuda (default; raises "
                        "without a card) or cpu")

    q = sub.add_parser("query", help="run a PromQL range query")
    q.add_argument("promql")
    q.add_argument("--host", default="http://127.0.0.1:8080")
    q.add_argument("--dataset", default="prometheus")
    q.add_argument("--start", type=float, required=True, help="unix seconds")
    q.add_argument("--end", type=float, required=True)
    q.add_argument("--step", default="15s")
    q.add_argument("--resolution", default=None, metavar="RES",
                   help="retention routing override: serve the query from "
                        "this resolution ('raw', '1m', ...) instead of the "
                        "router's choice; the server validates it against "
                        "the configured set and fails with the available "
                        "list (select ds columns with metric::dAvg)")

    lv = sub.add_parser("labelvalues", help="list label values")
    lv.add_argument("label")
    lv.add_argument("--host", default="http://127.0.0.1:8080")
    lv.add_argument("--dataset", default="prometheus")

    se = sub.add_parser("series", help="list series matching a selector "
                                       "(timeseriesMetadata analog)")
    se.add_argument("matcher", help='PromQL selector, e.g. m{dc="east"}')
    se.add_argument("--host", default="http://127.0.0.1:8080")
    se.add_argument("--dataset", default="prometheus")
    se.add_argument("--start", type=float, default=0.0)
    se.add_argument("--end", type=float, default=4102444800.0)

    st = sub.add_parser("status", help="cluster/shard status; --dataset/"
                                       "--shard drill into one shard")
    st.add_argument("--host", default="http://127.0.0.1:8080")
    st.add_argument("--dataset", default=None)
    st.add_argument("--shard", type=int, default=None)

    cu = sub.add_parser("cluster", help="elasticity view: membership table, "
                                        "per-node epoch/health, shard map, "
                                        "last-failover info; --rebalance "
                                        "moves a live shard")
    cu.add_argument("--host", default="http://127.0.0.1:8080")
    cu.add_argument("--rebalance", type=int, default=None, metavar="SHARD",
                    help="move this shard to --to (POSTs "
                         "/api/v1/cluster/rebalance on the owner)")
    cu.add_argument("--to", default=None, metavar="NODE",
                    help="rebalance target node identity")
    cu.add_argument("--dataset", default="prometheus",
                    help="dataset of --rebalance")

    ds = sub.add_parser("dataset", help="dataset operations (init/list/"
                                        "validateSchemas analogs)")
    dsub = ds.add_subparsers(dest="dscmd", required=True)
    dc = dsub.add_parser("create", help="register a dataset in a durable "
                                        "column store directory")
    dc.add_argument("--data-dir", required=True)
    dc.add_argument("--dataset", required=True)
    dc.add_argument("--schema", default="gauge")
    dc.add_argument("--shards", type=int, default=1)
    dv = dsub.add_parser("validate", help="resolve + validate a schema "
                                          "definition, print its layout")
    dv.add_argument("--schema", default=None, help="schema name")
    dv.add_argument("--config", default=None, help="server config json "
                                                   "(validates its schema)")
    dl = dsub.add_parser("list", help="list datasets")
    dl.add_argument("--data-dir", default=None)
    dl.add_argument("--host", default=None)

    ic = sub.add_parser("importcsv", help="ingest a CSV into a running server's bus "
                                          "or print container stats")
    ic.add_argument("csv")
    ic.add_argument("--bus", required=True, help="file-bus path to publish to")

    bk = sub.add_parser("broker", help="start one broker node of the "
                                       "replicated ingest tier (partitions, "
                                       "quorum acks, failover)")
    bk.add_argument("--config", default=None,
                    help="server config json (bus_addrs is the shared peers "
                         "list; ingest.* keys size the tier)")
    bk.add_argument("--data-dir", required=True,
                    help="partition log + pub-id journal directory")
    bk.add_argument("--node-index", type=int, default=0,
                    help="this node's index in bus_addrs")
    bk.add_argument("--host", default="127.0.0.1")
    bk.add_argument("--port", type=int, default=0,
                    help="bind port (0 = any; must match bus_addrs entry "
                         "for replicated tiers)")

    args = p.parse_args(argv)
    if args.cmd == "serve":
        return _serve(args)
    if args.cmd == "query":
        # --resolution is a ROUTING OVERRIDE on the raw dataset's endpoint,
        # not a dataset swap: the old ds_family swap silently returned an
        # empty result when the resolution was unconfigured (a nonexistent
        # dataset); the server now validates and names the available set
        params = {"query": args.promql, "start": args.start,
                  "end": args.end, "step": args.step}
        if args.resolution:
            params["resolution"] = args.resolution
        return _http_get(args.host,
                         f"/promql/{args.dataset}/api/v1/query_range",
                         params)
    if args.cmd == "labelvalues":
        return _http_get(args.host, f"/promql/{args.dataset}/api/v1/label/{args.label}/values", {})
    if args.cmd == "series":
        return _http_get(args.host, f"/promql/{args.dataset}/api/v1/series",
                         {"match[]": args.matcher, "start": args.start,
                          "end": args.end})
    if args.cmd == "status":
        return _status(args)
    if args.cmd == "cluster":
        return _cluster(args)
    if args.cmd == "dataset":
        return _dataset(args)
    if args.cmd == "importcsv":
        from .ingest.bus import FileBus
        from .ingest.stream import CsvStream
        bus = FileBus(args.bus)
        total = 0
        for _, container in CsvStream(args.csv):
            bus.publish(container)
            total += len(container)
        print(f"published {total} samples to {args.bus}")
        return 0
    if args.cmd == "broker":
        return _broker(args)
    return 2


def _broker(args) -> int:
    """One node of the replicated broker tier (ingest/broker.py +
    ingest/replication.py), sized from the declared ingest.* config."""
    from .config import Config
    from .ingest.broker import BrokerServer
    from .ingest.faults import plan_from_config
    from .standalone import _pow2

    cfg = Config.load(args.config)
    peers = list(cfg.get("bus_addrs") or [])
    partitions = int(cfg.get("ingest.partitions")
                     or _pow2(cfg["num_shards"]))
    srv = BrokerServer(
        args.data_dir, partitions, host=args.host, port=args.port,
        peers=peers, node_index=args.node_index,
        replication=cfg["ingest.replication"],
        min_insync=cfg["ingest.min_insync"],
        max_queue=cfg["ingest.max_partition_queue"],
        fault_plan=plan_from_config(cfg),
        epoch_fencing=cfg["ingest.epoch_fencing"]).start()
    role = "replicated" if len(peers) > 1 and cfg["ingest.replication"] > 1 \
        else "single"
    print(f"filodb_tpu_torch broker ({role}) node {args.node_index} serving "
          f"{partitions} partition(s) on :{srv.port}")
    _wait_for_interrupt()
    srv.stop()
    return 0


def _wait_for_interrupt() -> None:
    """Block until SIGINT or SIGTERM (a supervisor's stop), so the caller's
    orderly shutdown runs either way."""
    import signal
    import threading
    done = threading.Event()

    def stop(*_a):
        done.set()

    signal.signal(signal.SIGTERM, stop)
    signal.signal(signal.SIGINT, stop)
    while not done.wait(3600):
        pass


def _serve(args) -> int:
    from .config import Config
    from .standalone import FiloServer

    over: dict = {}
    if args.port is not None:
        over["http"] = {"port": args.port}
    if args.dataset is not None:
        over["dataset"] = args.dataset
    if args.schema is not None:
        over["schema"] = args.schema
    if args.shards is not None:
        over["num_shards"] = args.shards
    if args.data_dir is not None:
        over["data_dir"] = args.data_dir
    cfg = Config.load(args.config, over)
    server = FiloServer(cfg, device=args.device).start()
    dataset = cfg["dataset"]
    if args.seed_data:
        from .ingest.stream import SyntheticStream
        shards = sorted(s.shard_num
                        for s in server.memstore.shards_of(dataset))
        for off, c in SyntheticStream():
            server.memstore.ingest(dataset, shards[off % len(shards)], c,
                                   off)
        server.memstore.flush_all()
    print(f"filodb_tpu_torch serving dataset {dataset!r} on "
          f":{server.http.port} ({server.device})", flush=True)
    try:
        _wait_for_interrupt()
    finally:
        server.shutdown()
    return 0


def _fetch_json(host: str, path: str, params: dict | None = None):
    import urllib.parse
    import urllib.request
    url = host + path + ("?" + urllib.parse.urlencode(params) if params else "")
    with urllib.request.urlopen(url) as r:
        return json.load(r)


def _status(args) -> int:
    """Cluster status; with --dataset (and optionally --shard) drill into
    per-shard rows with live series counts (ref: CliMain dumpShardStatus —
    per-shard status lines)."""
    payload = _fetch_json(args.host, "/api/v1/cluster/status")
    data = payload.get("data", payload)
    if args.dataset is None:
        print(json.dumps(payload, indent=2))
        return 0
    shards = (data.get("datasets", {}).get(args.dataset)
              or data.get("shards"))
    if shards is None:
        print(f"dataset {args.dataset!r} unknown to the cluster", file=sys.stderr)
        return 1
    # live per-shard series counts from the metrics endpoint
    counts: dict[str, str] = {}
    try:
        import urllib.request
        with urllib.request.urlopen(args.host + "/metrics") as r:
            for line in r.read().decode().splitlines():
                if line.startswith("filodb_shard_num_series{"):
                    labels, val = line[len("filodb_shard_num_series"):].rsplit(" ", 1)
                    if f'dataset="{args.dataset}"' in labels:
                        import re as _re
                        m = _re.search(r'shard="(\d+)"', labels)
                        if m:
                            counts[m.group(1)] = val.strip()
    except Exception:  # noqa: BLE001  # filolint: ignore[except-swallow]
        # metrics endpoint optional: older servers don't expose /metrics and
        # the status table just omits the live series counts. This is a
        # short-lived CLI process with no metrics export of its own, so a
        # counter here would be dead telemetry — degrade silently by design.
        pass
    if isinstance(shards, dict):
        rows = sorted(shards.items(), key=lambda kv: int(kv[0]))
    else:   # single-node fallback shape: list of shard dicts
        rows = [(str(s["shard"]), s) for s in shards
                if s.get("dataset") == args.dataset]
        if not rows:
            print(f"dataset {args.dataset!r} unknown to the server",
                  file=sys.stderr)
            return 1
    shown = 0
    for sid, info in rows:
        if args.shard is not None and int(sid) != args.shard:
            continue
        node = info.get("node", "-")
        status = info.get("status", "-")
        nseries = counts.get(str(sid), info.get("numSeries", "-"))
        print(f"shard {sid:>4}  node={node}  status={status}  "
              f"numSeries={nseries}")
        shown += 1
    if args.shard is not None and not shown:
        print(f"shard {args.shard} not found in dataset {args.dataset!r}",
              file=sys.stderr)
        return 1
    return 0


def _cluster(args) -> int:
    """Elasticity view of GET /api/v1/cluster/status: membership table
    (gossip state/heartbeats), per-node epochs, the shard map, and the
    last failover/rebalance event. With --rebalance SHARD --to NODE, POSTs
    a live shard move to the owner instead."""
    if args.rebalance is not None:
        if not args.to:
            print("--rebalance needs --to NODE", file=sys.stderr)
            return 2
        import urllib.parse
        import urllib.request
        qs = urllib.parse.urlencode({"dataset": args.dataset,
                                     "shard": args.rebalance,
                                     "to": args.to})
        req = urllib.request.Request(
            f"{args.host}/api/v1/cluster/rebalance?{qs}", method="POST",
            data=b"")
        with urllib.request.urlopen(req) as r:
            print(json.dumps(json.load(r), indent=2))
        return 0
    payload = _fetch_json(args.host, "/api/v1/cluster/status")
    data = payload.get("data", payload)
    print(f"nodes: {', '.join(data.get('nodes', [])) or '-'}")
    rows = data.get("membership")
    if rows:
        print("\nmembership:")
        for m in rows:
            mark = "*" if m.get("self") else " "
            print(f" {mark} {m['node']:<24} state={m['state']:<8} "
                  f"hb={m['heartbeat']:<8} inc={m['incarnation']:<3} "
                  f"stale_rounds={m['stale_rounds']}")
    epochs = (data.get("epochs") or {}).get("shards")
    if epochs:
        print("\nshard epochs (this node's claims):")
        for s, e in sorted(epochs.items(), key=lambda kv: int(kv[0])):
            print(f"   shard {s:>4}  epoch={e}")
    print("\nshard map:")
    for ds, shards in sorted((data.get("datasets") or {}).items()):
        for sid, info in sorted(shards.items(), key=lambda kv: int(kv[0])):
            print(f"   {ds}/{sid:>4}  node={info.get('node', '-')}  "
                  f"status={info.get('status', '-')}")
    bad = data.get("known_bad_windows")
    if bad:
        print("\nknown-bad windows (buddy-routed):")
        for key, start in sorted(bad.items()):
            print(f"   {key}  since_ms={start}")
    lf = data.get("last_failover")
    if lf:
        print(f"\nlast failover: {json.dumps(lf)}")
    return 0


def _dataset(args) -> int:
    """Dataset verbs (ref: CliMain init/list/validateSchemas)."""
    if args.dscmd == "create":
        from .core.schemas import Schemas
        from .core.store import FileColumnStore
        # the schema registry alone: a memstore would claim a device
        schemas = Schemas()
        try:
            schema = schemas[args.schema]
        except KeyError:
            print(f"unknown schema {args.schema!r}; available: "
                  f"{sorted(schemas.by_name)}", file=sys.stderr)
            return 1
        store = FileColumnStore(args.data_dir)
        for shard in range(args.shards):
            meta = store.read_meta(args.dataset, shard) or {}
            meta.update({"schema": schema.name, "num_shards": args.shards})
            store.write_meta(args.dataset, shard, meta)
        print(f"created dataset {args.dataset!r} ({args.shards} shards, "
              f"schema {schema.name}) in {args.data_dir}")
        return 0
    if args.dscmd == "validate":
        from .core.schemas import Schemas
        schemas = Schemas()
        name = args.schema
        if args.config:
            with open(args.config) as f:
                name = json.load(f).get("schema", "gauge")
        if name is None:
            names = sorted(schemas.by_name)
        else:
            names = [name]
        rc = 0
        for nm in names:
            try:
                sch = schemas[nm]
            except KeyError:
                print(f"{nm}\tUNKNOWN (available: {sorted(schemas.by_name)})")
                rc = 1
                continue
            cols = ", ".join(f"{c.name}:{c.ctype.name.lower()}"
                             + (":counter" if c.is_counter else "")
                             for c in sch.columns)
            print(f"{nm}\tOK\tcolumns=[{cols}]\tvalue_column={sch.value_column}"
                  f"\tdownsamplers={list(sch.downsamplers)}")
        return rc
    if args.dscmd == "list":
        if args.host:
            payload = _fetch_json(args.host, "/api/v1/cluster/status")
            data = payload.get("data", payload)
            names = sorted(data.get("datasets", {})) or sorted(
                {s["dataset"] for s in data.get("shards", [])})
            for n in names:
                print(n)
            return 0
        if args.data_dir:
            import os
            if not os.path.isdir(args.data_dir):
                print(f"no such directory {args.data_dir}", file=sys.stderr)
                return 1
            for n in sorted(os.listdir(args.data_dir)):
                if os.path.isdir(os.path.join(args.data_dir, n)):
                    print(n)
            return 0
        print("dataset list needs --host or --data-dir", file=sys.stderr)
        return 2
    return 2


def _http_get(host: str, path: str, params: dict) -> int:
    print(json.dumps(_fetch_json(host, path, params), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
