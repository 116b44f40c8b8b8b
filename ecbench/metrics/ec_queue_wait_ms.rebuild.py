"""ec_queue_wait_ms.rebuild (ms): the RS rebuild's producer blocked on the
shard writer: each put on a full queue, and the writer's drain at the end
of the job, per job: seaweedfs_ec_queue_wait_seconds{op=rebuild} over the
window.  (The Clay rebuild runs no writer thread.)"""

from ecbench import stages


def read(run):
    return stages.stage_ms(run, "ec_queue_wait", "rebuild")
