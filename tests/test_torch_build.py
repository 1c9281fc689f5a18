"""The kernel build of the port (dpu_olap_tpu_torch.ops._kernels.build) with
a stand-in compiler: one compile per csrc/*.cu source, then one link of
their objects into the hash-named library; a failed compile raises with the
compiler's output and leaves nothing behind."""

import sys
import textwrap

import pytest

from dpu_olap_tpu_torch.ops import _kernels

FAKE_NVCC = textwrap.dedent(
    """\
    import os
    import sys
    args = sys.argv[1:]
    out = args[args.index("-o") + 1]
    if os.environ.get("FAKE_NVCC_FAIL") and "-c" in args and args[-1].endswith(os.environ["FAKE_NVCC_FAIL"]):
        print("error: stand-in failure", file=sys.stderr)
        sys.exit(2)
    with open(out, "w") as f:
        f.write(" ".join(args))
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write(" ".join(args) + "\\n")
    """
)


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    script.chmod(0o755)
    log = tmp_path / "calls.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(_kernels, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "_build")
    return log


def test_build_compiles_each_source_then_links(fake_nvcc):
    so = _kernels.build()
    assert so == _kernels.library_path() and so.exists()
    calls = fake_nvcc.read_text().splitlines()
    srcs = [s.name for s in _kernels._sources()]
    assert {"filter.cu", "gather.cu", "scan.cu", "sort.cu", "sum.cu"} <= set(srcs)
    compiles = [c for c in calls if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == sorted(srcs)
    (link,) = [c for c in calls if "-shared" in c]
    assert link.count(".o") == len(srcs)
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert sorted(p.name for p in so.parent.iterdir()) == [so.name]  # objects removed
    assert _kernels.build() == so and len(fake_nvcc.read_text().splitlines()) == len(calls)


def test_build_failure_raises_with_compiler_output(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "sum.cu")
    with pytest.raises(RuntimeError, match="stand-in failure"):
        _kernels.build()
    assert list(_kernels.BUILD_DIR.iterdir()) == []
