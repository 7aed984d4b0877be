"""A run leaves no process behind: the reference's pool and the tracker it
starts end before ``plan_all`` returns, and ``stop_all`` ends any other
child."""

import subprocess

from h100_bench.core import check, manifest, procs, traffic


def test_the_reference_pool_leaves_no_process():
    files = manifest.cell_files(manifest.load(), "default.single")
    conf = manifest.read(files["config"])
    a = traffic.arrays(conf, manifest.read(files["traffic"]), 4, 2**31 + 3)
    answers = check.plan_all(conf, [traffic.query(a, 0)], workers=1)
    assert len(answers) == 1
    assert procs.children() == []


def test_stop_all_ends_a_child_that_would_outlive_the_run():
    child = subprocess.Popen(["sleep", "300"])
    assert child.pid in procs.children()
    procs.stop_all(grace_s=0.1)
    assert procs.children() == []
