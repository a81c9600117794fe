"""No module a run loads has the top-level name jax, jaxlib, flax or
hm16_2_tpu; the reference loads nothing of hm16_2_tpu_torch either."""

import subprocess
import sys
import textwrap

from pb_testlib import PB, ROOT

import run

PRELUDE = f"""
import sys
sys.path[:0] = [{ROOT!r}, {PB!r}]
"""


def _py(code, timeout=600):
    r = subprocess.run([sys.executable, "-c", PRELUDE + textwrap.dedent(code)],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _loaded_tops(stdout):
    return set(stdout.strip().splitlines()[-1].split(","))


def test_run_modules():
    stdout = _py("""
        import torch
        torch.set_num_threads(1)
        sys.path.insert(0, "portbench/tests")
        from pb_testlib import FakeTrace, small_cell
        import pb_trace, run
        pb_trace.DeviceTrace = FakeTrace
        cfg, traffic, metrics = small_cell("ai-main-1080p.qp32", 192, 128)
        res = run.run_cell(cfg, traffic, metrics, 31337, 6, 1,
                           torch.device("cpu"), log=lambda s: None)
        assert res["correct"], res
        assert run.forbidden_modules() == []
        print(",".join(sorted({m.split(".")[0] for m in sys.modules})))
        """)
    tops = _loaded_tops(stdout)
    assert "hm16_2_tpu_torch" in tops and "hevcref" in tops
    assert not tops & set(run.FORBIDDEN)


def test_reference_loads_nothing_of_the_port(tmp_path):
    """The port codes a short stream in one process; a second, in which
    importing hm16_2_tpu_torch fails, judges it with the reference."""
    rec = tmp_path / "rec.pkl"
    _py(f"""
        import pickle, torch
        torch.set_num_threads(1)
        import pb_content, pb_drive, run
        from hm16_2_tpu_torch.encode.top import Encoder, EncoderConfig
        cell, cfg, traffic, metrics = run.load_cell("ra-main-1080p.qp32")
        w, h = 128, 64
        frames = pb_content.make_frames(traffic, w, h, 17, 99, torch.device("cpu"))
        enc = Encoder(EncoderConfig(w, h, **dict(cfg["encoder"], qp=32)),
                      torch.device("cpu"))
        rec = pb_drive.Recorder(enc)
        cl = pb_drive.Client(enc, rec, frames, "push")
        while len(rec.order) < 17:
            cl.step()
        pics = {{p: {{k: r[k] for k in ("au", "recon", "plan", "slice_type")
                     if k in r}} for p, r in rec.pics.items()}}
        pickle.dump((dict(cfg, width=w, height=h), frames, pics, rec.order),
                    open({str(rec)!r}, "wb"))
        """)
    stdout = _py(f"""
        import pickle, torch
        torch.set_num_threads(1)
        for name in ("hm16_2_tpu_torch", "hm16_2_tpu", "jax"):
            sys.modules[name] = None        # any import of them fails
        import pb_check
        cfg, frames, pics, order = pickle.load(open({str(rec)!r}, "rb"))
        window = order[9:]
        nums, failed, lines = pb_check.check(dict(cfg, qp=32), frames, pics,
                                             order, window, 5,
                                             torch.device("cpu"))
        assert all(v == 0 for v in nums.values()), (nums, lines)
        loaded = {{m.split(".")[0] for m, v in sys.modules.items()
                   if v is not None}}
        print(",".join(sorted(loaded)))
        """)
    tops = _loaded_tops(stdout)
    assert "hevcref" in tops
    assert not tops & {"hm16_2_tpu_torch", "hm16_2_tpu", "jax", "jaxlib",
                       "flax"}


def test_forbidden_names_are_whole_top_level_names():
    mods = dict(sys.modules)
    before = set(run.forbidden_modules())
    try:
        sys.modules["hm16_2_tpu_torchx"] = sys
        sys.modules["jaxlike.sub"] = sys
        assert set(run.forbidden_modules()) == before
        sys.modules["hm16_2_tpu.encode"] = sys
        assert set(run.forbidden_modules()) - before <= {"hm16_2_tpu"}
        assert "hm16_2_tpu" in run.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in mods:
                del sys.modules[k]
