"""Per-node launcher: one process per GPU, supervised as a group.

Port of ``deepspeed_tpu/launcher/launch.py`` with the reference
DeepSpeed launcher's process model (the JAX one runs one process per host
over all its chips). From the base64 world layout it takes this node's
GPU slots and starts one worker per slot, each with

- ``LOCAL_RANK`` = its index among the node's slots,
- ``RANK`` = the number of slots of the nodes before this one plus
  ``LOCAL_RANK`` (``node_rank * ngpus + local_rank`` when every node has
  ``ngpus`` slots),
- ``WORLD_SIZE`` = the number of slots of all nodes,
- ``MASTER_ADDR`` / ``MASTER_PORT``, ``NODE_RANK``, and
- ``CUDA_VISIBLE_DEVICES`` = the node's slots, so that ``LOCAL_RANK``
  indexes its own GPU,

which ``utils/distributed.py`` reads to start ``torch.distributed``. The
workers run under ``WorkerSupervisor`` (``launcher/supervisor.py``) as
one group: SIGTERM and SIGINT are forwarded to every worker, a worker
that dies takes the group down and, with ``--max_restarts``, the group is
restarted (no backoff after a preemption, exit 99); the group's exit code
is propagated. A serving fleet runs its replicas the same way:
``--replica_port P`` (worker i binds P + i) and ``--replica_config`` export
``DSTPU_REPLICA_PORT`` / ``DSTPU_REPLICA_CONFIG`` to each worker
(``python -m deepspeed_tpu_torch.inference.serving.replica`` reads them),
and ``--collector_port`` runs a ``FleetCollector`` beside the supervisor
over the workers' telemetry endpoints.

    python -m deepspeed_tpu_torch.launcher.launch --world_info=<b64> --node_rank=0 train.py ...
"""

import argparse
import os
import sys

from deepspeed_tpu_torch.launcher.runner import decode_world_info
from deepspeed_tpu_torch.launcher.supervisor import WorkerSupervisor
from deepspeed_tpu_torch.utils.distributed import TORCH_DISTRIBUTED_DEFAULT_PORT
from deepspeed_tpu_torch.utils.logging import logger


def parse_args(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--world_info", default="e30=", type=str,
                        help="base64-encoded world layout dictionary {host: [gpu slots]}")
    parser.add_argument("--node_rank", default=0, type=str,
                        help="Rank of this node in the job, or 'MPI'/'OMPI' to read it "
                             "from the MPI launcher env (OpenMPI/MVAPICH2/PMI)")
    parser.add_argument("--master_addr", default="127.0.0.1", type=str)
    parser.add_argument("--master_port", default=TORCH_DISTRIBUTED_DEFAULT_PORT, type=int)
    parser.add_argument("--max_restarts", default=0, type=int,
                        help="Restart budget for a crashed/preempted/hung worker group "
                             "(0 = run once)")
    parser.add_argument("--restart_backoff_s", default=1.0, type=float,
                        help="Base of the exponential backoff between crash restarts")
    parser.add_argument("--heartbeat_timeout_s", default=0.0, type=float,
                        help="Kill and restart the group when a worker's step heartbeat "
                             "goes stale for this long (0 = no liveness monitoring; must "
                             "exceed the first step's kernel build)")
    parser.add_argument("--telemetry_port", default=None, type=int,
                        help="Serve /healthz, /metrics, /snapshot and /trace from "
                             "the supervisor on this port (0 = ephemeral; omit to "
                             "disable)")
    parser.add_argument("--worker_telemetry_port", default=None, type=int,
                        help="Fixed port of the WORKERS' telemetry endpoints: local "
                             "worker i binds this port + i (exported as "
                             "DSTPU_TELEMETRY_PORT; survives restarts)")
    parser.add_argument("--replica_port", default=None, type=int,
                        help="Fixed port of the SERVING replicas' request sockets: "
                             "local worker i binds this port + i (exported as "
                             "DSTPU_REPLICA_PORT; survives restarts so a fleet "
                             "router's endpoint list never goes stale)")
    parser.add_argument("--replica_config", default=None, type=str,
                        help="Replica config JSON path (exported as "
                             "DSTPU_REPLICA_CONFIG for inference/serving/replica.py "
                             "workers)")
    parser.add_argument("--collector_port", default=None, type=int,
                        help="Run a FleetCollector next to the supervisor, serving "
                             "/fleet/metrics, /fleet/trace and /fleet/snapshot on "
                             "this port (0 = ephemeral). Scrapes the workers' "
                             "endpoints (requires --worker_telemetry_port) and "
                             "merges the supervisor's own restart instants")
    parser.add_argument("training_script", type=str)
    parser.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return parser.parse_args(sys.argv[1:] if args is None else list(args))


def mpi_node_rank():
    """Generic MPI rank discovery: OpenMPI, MVAPICH2, or PMI launchers."""
    return int(
        os.environ.get("OMPI_COMM_WORLD_RANK")
        or os.environ.get("MV2_COMM_WORLD_RANK")
        or os.environ.get("PMI_RANK")
        or "0"
    )


def worker_envs(world_info, node_rank, master_addr, master_port):
    """The environment of each of this node's workers (one a GPU slot),
    as the entries a worker's environment gets on top of the launcher's."""
    hosts = list(world_info.keys())
    slots = world_info[hosts[node_rank]]
    first_rank = sum(len(world_info[h]) for h in hosts[:node_rank])
    world_size = sum(len(s) for s in world_info.values())
    visible = ",".join(map(str, slots))
    return [{"MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port),
             "WORLD_SIZE": str(world_size), "RANK": str(first_rank + local_rank),
             "LOCAL_RANK": str(local_rank), "NODE_RANK": str(node_rank),
             "CUDA_VISIBLE_DEVICES": visible}
            for local_rank in range(len(slots))]


def main(args=None):
    args = parse_args(args)
    world_info = decode_world_info(args.world_info)
    assert len(world_info) > 0, "got no world info"

    if args.node_rank in ("OMPI", "MPI"):
        node_rank = mpi_node_rank()
    else:
        node_rank = int(args.node_rank)

    hosts = list(world_info.keys())
    num_nodes = len(hosts)
    if not 0 <= node_rank < num_nodes:
        logger.error(
            f"launch: node_rank {node_rank} is out of range for this world "
            f"layout ({num_nodes} host(s): {hosts}) — check --node_rank / the "
            "MPI rank env against the hostfile"
        )
        sys.exit(2)
    this_host = hosts[node_rank]
    local_slots = world_info[this_host]
    if not local_slots:
        logger.error(f"launch: host {this_host} has no GPU slot in the world layout")
        sys.exit(2)

    envs = worker_envs(world_info, node_rank, args.master_addr, args.master_port)
    logger.info(
        f"launch: node_rank={node_rank}/{num_nodes} host={this_host} "
        f"slots={local_slots} ranks={[e['RANK'] for e in envs]} "
        f"world_size={envs[0]['WORLD_SIZE']} master={args.master_addr}:{args.master_port} "
        f"max_restarts={args.max_restarts}"
    )

    cmd = [sys.executable, "-u", args.training_script] + args.training_script_args
    supervisor = WorkerSupervisor(
        cmd, env=os.environ.copy(), local_envs=envs,
        max_restarts=args.max_restarts,
        backoff_s=args.restart_backoff_s,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        http_port=args.telemetry_port,
        worker_port=args.worker_telemetry_port,
        replica_port=args.replica_port,
        replica_config=args.replica_config,
        rank=int(envs[0]["RANK"]),
        log=lambda msg: logger.warning(f"launch[{node_rank}]: {msg}"),
    )
    collector = None
    if args.collector_port is not None:
        collector = _start_collector(supervisor, args.collector_port, node_rank)
    try:
        rc = supervisor.run()
    finally:
        if collector is not None:
            collector.stop()
    sys.exit(rc)


def _start_collector(supervisor, port, node_rank):
    """A FleetCollector over the supervised workers' telemetry endpoints,
    with the supervisor's own lifecycle instants and liveness gauges
    merged in, served on ``port``."""
    from deepspeed_tpu_torch import telemetry

    collector = telemetry.FleetCollector()
    for i, url in enumerate(supervisor.worker_endpoints or []):
        collector.add_endpoint(rank=supervisor.rank + i, url=url)
    if supervisor.worker_endpoints is None:
        logger.warning("launch: --collector_port without --worker_telemetry_port: the "
                       "collector has no worker endpoint to scrape (serving "
                       "supervisor-side telemetry only)")
    # arm the launcher-side tracer so the supervisor's lifecycle instants
    # (worker/restart, worker/exit) are recorded, then merge them and the
    # liveness gauges into the fleet view
    telemetry.configure(True)
    telemetry.get_tracer().set_process_info(rank=-1, role="supervisor")
    supervisor.export_gauges(telemetry.get_registry())
    collector.attach_local(telemetry.get_tracer(), telemetry.get_registry())
    srv = collector.serve(port=port)
    logger.info(f"launch[{node_rank}]: fleet collector at {srv.url}/fleet/metrics")
    return collector


if __name__ == "__main__":
    main()
