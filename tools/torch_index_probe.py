#!/usr/bin/env python3
"""Count the device-to-host copies that indexing by a 0-d CUDA tensor makes.

``x[torch.argmin(f)]`` on a CUDA tensor reads the index on the host (a
``Memcpy DtoH`` that waits for the queue); ``index_select`` of the same
index does not. Prints the copies a call of each form makes, from the
profiler's ``Memcpy DtoH`` rows, over 10 calls. Run on a machine with a
card::

    python3 tools/torch_index_probe.py
"""

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


def main() -> None:
    x = torch.randn(4096, 256, device="cuda")
    f = torch.randn(4096, device="cuda")
    forms = (
        ("x[argmin], f[argmin]", lambda: (x[torch.argmin(f)], f[torch.argmin(f)])),
        ("index_select, amin", lambda: (x.index_select(0, torch.argmin(f).reshape(1))[0],
                                        torch.amin(f))),
    )
    for name, fn in forms:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        copies = sum(e.count for e in prof.key_averages()
                     if "Memcpy DtoH" in e.key and e.device_type == DeviceType.CUDA)
        print(f"{name}: {copies / 10} device-to-host copies a call", flush=True)


if __name__ == "__main__":
    main()
