"""Protected serving example on the PyTorch/CUDA port (the counterpart of
`examples/serve_protected.py`): batched generation on simulated PIM
hardware with the paper's fault model injected, NB-LDPC correcting every
target projection on the fly (the paper's deployment scenario).

Run:  PYTHONPATH=src python scripts/serve_protected_torch.py [--cpu]
(on the card; `--cpu` runs the kernels' plain versions on the CPU)
"""
import sys

from repro_torch.launch import serve

if __name__ == "__main__":
    dev = ["--device", "cpu"] if "--cpu" in sys.argv[1:] else []
    print("=== clean PIM (protection on, no faults) ===")
    serve.main(["--arch", "paper_pim", "--reduced", "--batch", "4",
                "--prompt-len", "16", "--gen", "8", "--protect", *dev])
    print("\n=== faulty PIM (rate 1e-3) + NB-LDPC correction ===")
    serve.main(["--arch", "paper_pim", "--reduced", "--batch", "4",
                "--prompt-len", "16", "--gen", "8", "--protect",
                "--fault-rate", "1e-3", *dev])
