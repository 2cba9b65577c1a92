"""chip_smoke.py rehearsed on the CPU. The device check must refuse the
CPU; the query and host-mirror phases run on a tiny seeded corpus by
calling the phase functions directly (only the platform check is
bypassed)."""

import jax
import pytest

import chip_smoke as S
from fulgor_tpu.index import Index
from fulgor_tpu.io.simulate import simulate_pangenome
from fulgor_tpu.query.engine import QueryEngine

N_READS = 300
BATCH = 256


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("smoke_cpu")
    paths = simulate_pangenome(str(tmp / "g"), 4, 4000, 20, seed=1)
    index, _sec = S.build_index_cli(paths, str(tmp / "tiny"))
    reads_path = str(tmp / "reads.fq")
    reads = S.write_reads(paths, N_READS, 2, reads_path)
    eng = QueryEngine(Index.load(index), batch_size=BATCH)
    return tmp, index, reads_path, reads, eng


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        S.check_device(jax.devices())


def test_query_and_host_mirror_phases(tiny):
    tmp, index, reads_path, reads, eng = tiny
    assert len(reads) == N_READS + 3
    assert len(reads[N_READS][1]) == S.LONG_READ_LEN
    assert len(reads[-1][0]) > 250
    res = S.query_phase(eng, "tiny", index, reads_path, reads, N_READS,
                        str(tmp), batch=BATCH)
    # FULGOR_SELFCHECK=64 samples every 64th read id; the long read is
    # left to the host path and not counted
    assert res["FI"][1] == res["TU(0.8)"][1] == -(-N_READS // 64)
    assert res["kc"][1] == res["km"][1] == N_READS + 3


@pytest.mark.parametrize("tool", ["kc", "km"])
def test_host_mirror_check_catches_a_differing_line(tiny, tool):
    tmp, index, reads_path, reads, eng = tiny
    out = str(tmp / f"{tool}.tsv")
    header = None
    if tool == "kc":
        eng.kmer_conservation_file(reads_path, out)
        line = S.host_kc_line
    else:
        eng.kmer_matches_file(reads_path, out)
        line = S.host_km_line
        header = f"num_colors={eng.idx.num_colors}"
    sample = S.sample_reads(reads, N_READS)
    assert S.check_host_lines(eng, out, sample, line, header) == len(sample)
    lines = open(out).read().splitlines(True)
    i = 1 if header else 0
    lines[i] = lines[i].rstrip("\n") + "\t9\n"
    with open(out, "w") as f:
        f.writelines(lines)
    with pytest.raises(SystemExit, match="differ from the host mirror"):
        S.check_host_lines(eng, out, sample, line, header)
