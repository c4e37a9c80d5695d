"""One gloo rank of the multi-rank sharded row of ``test_torch_sharded.py``.

Started by ``torch.multiprocessing`` (spawn); imports only ``torch`` and
``repro_torch``. The rank joins a default group through a ``FileStore``
(no network port), trains the tiny sharded run on the CPU and puts its
gathered parameters, bytes and mesh coordinates on the queue.
"""
import traceback

import torch
import torch.distributed as dist


def run_rank(rank, world, store_path, cfg_kw, ckpt_dir, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.api import ExperimentConfig, Trainer
        from repro_torch.tree import tree_leaves
        cfg = ExperimentConfig(backend="sharded", ckpt_dir=ckpt_dir,
                               **cfg_kw)
        trainer = Trainer(cfg, device="cpu")
        res = trainer.run()
        mesh = trainer.backend.mesh
        queue.put({"rank": rank, "size": mesh.size, "m_loc": mesh.m_loc,
                   "i0": mesh.i0, "comm_bytes": res.comm_bytes,
                   "collectives": trainer.backend.collectives,
                   "params": [t.numpy() for t in tree_leaves(res.params)],
                   "losses": [e["loss"] for e in res.history]})
    except Exception:
        queue.put({"rank": rank, "error": traceback.format_exc()})
        raise
    finally:
        dist.destroy_process_group()
