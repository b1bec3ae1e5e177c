#!/usr/bin/env python3
"""On-card smoke check of the PyTorch port (``zhpe_ompi_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Print the card's name and power limit, as nvidia-smi reports them.
2. Build every kernel of the main path from ``zhpe_ompi_tpu_torch/csrc``
   (one ``nvcc`` per source, started together) and time the build.
3. Hold each kernel against its plain PyTorch version at the shapes the
   main path gives it (layernorm forward and backward 8192 x 1024 bf16;
   flash attention forward, dq and dk/dv (16, 512, 16, 64) bf16 causal;
   the serving forward's layernorm (2048, 1024) and flash (4, 512, 16, 64)),
   plus ragged and strided shapes and the flash kernels' edges (a 4096-long
   sequence, causal and not, whose ring phases wrap many times; S = 192,
   not a multiple of their 128-row blocks), check that dq (with delta) and
   dk/dv each give the same bits twice, and time kernel, plain version and the
   PyTorch library call that computes the same function (``F.layer_norm``,
   ``aten.native_layer_norm_backward``, ``F.scaled_dot_product_attention``
   and its autograd backward; timed as a yardstick only, never used by the
   port).  Then the host µs per call of the flash forward, dq and dk/dv
   wrappers (checks, tensor maps, launch) at the headline shape.
4. Hold the ring attention's block recurrence at (16, 512, 16, 64) bf16
   causal, the sequence cut into 4 blocks: for each virtual rank, the
   port's ``_chunk_attn`` over the blocks in the order the ring delivers
   them, then the normalisation, against ``_block_attention_single`` on
   the whole sequence (max abs error within 2e-2); the same with the
   zigzag layout's live sub-blocks; the time per rank of each.
5. The MPI entry point, at phase 7's flagship width, before any
   process group is made and before any profiler session runs:
   ``runtime.init()`` (timed) must give a one-rank NCCL COMM_WORLD and COMM_SELF and print the comm_method hook's lines (the
   world's layout and tuned over every operation); ``make_mesh({"dp": 1,
   "tp": 1, "sp": 1})`` then gives ``dp_comm`` from its dp group,
   ``tp_comm`` from ``world.split`` and ``sp_comm`` from a ``dup`` of its
   sp group.  With ``coll_monitoring_enable`` set, ``make_train_step``
   over ``dp_comm`` and ``tp_comm`` takes three steps: each must launch
   the kernels 9/9/4/4/4 times and raise the SPC counter
   ``coll_allreduce_calls`` by exactly the number of
   ``Communicator.allreduce`` calls the step makes (one per parameter on
   dp, one per tp-replicated parameter on tp, two for the loss, four per
   layer for the f/g pair: 30), split as counted per communicator.  On
   CUDA tensors: an allreduce on a revoked communicator raises
   ``Revoked``, ``shrink(failed=[])`` of it gives a working communicator,
   ``agree`` runs on it; ``probe_device_plane()`` at its default deadline
   returns "ok" (the child reports its seconds by stage), and with
   ``ZMPI_DEVICE_WEDGE`` set to "all" or to this rank it returns
   "deadline" or "hung" within its timeout.  Then
   ``zhpe_ompi_tpu_torch.bench``'s measurement (monitoring off again, on
   fresh communicators): the framework step against the plain step with
   remat on and off (step ms, tokens/s, ``vs_baseline``, mfu) and the
   long-context line, and one long-context step (seq 4096, batch 2,
   remat) between launch counts (17/9/8/4/4); then ``finalize()``, after
   which no process group is left.
6. On one-rank NCCL communicators (``tp``, ``dp``, ``sp``), whose
   collectives ``tuned`` serves over ``coll/nccl``: every entry of
   ``comm.coll``, and every algorithm of ``coll/algorithms.py`` forced
   through ``ZMPI_MCA_coll_tuned_<op>_algorithm``, on CUDA tensors of f32,
   bf16 and int32, must give the one-rank MPI answer.  Then the host µs
   per call of ``Communicator.allreduce`` through tuned and through a
   communicator composed without tuned, in 10 alternating turns, and of
   the nccl component's allreduce alone.
7. Drive the forward path at the flagship width (vocab 8192, d_model 1024,
   16 heads, d_ff 4096, 4 layers, seq 512, bf16, ce_chunk 1024, batch 16):
   numpy parameters in the JAX package's layout from a seed,
   ``params_from_numpy`` onto the card, ``tp_comm``, and three batches
   scored through ``forward`` and ``loss_fn``.  The kernels' launch counts
   (all five) are set to 0 just before and read just after; each forward
   must launch the layernorm kernel 9 times, the flash kernel 4 times and
   no backward kernel.  The losses
   must be finite and near ln(8192), and match the same forward with
   ``fused_ln=False, flash=False``; the logits product (bf16 operands, f32
   result) must match both operands upcast to f32.  Then steady-state
   times of ``forward`` and ``loss_fn`` and a torch.profiler breakdown of
   ``loss_fn`` are printed.
8. Drive the training path at the same width: ``make_train_step`` with
   ``dp_comm`` and ``tp_comm``, five SGD steps on one repeated batch.  The
   launch counts are set to 0 just before each step and read just after;
   each step must launch the layernorm forward and backward kernels 9
   times each and the flash forward, dq and dk/dv kernels 4 times each.
   The losses must be finite and the last below the first.  One step on
   the kernel path and one on the plain path (``fused_ln=False,
   flash=False``) from the same parameters and batch must agree in loss
   and in every parameter's update.  Then the steady step time (median,
   quartiles), tokens trained per second, the peak device memory, and a
   torch.profiler breakdown of one step are printed.
9. The same with ``remat=True``: each step must launch the layernorm
   forward 17 times and the flash forward 8 times (the recomputed layers),
   the backward kernels as before; the first step's loss is compared in
   its bits with the step without remat on the same parameters and batch,
   and each parameter's update must agree within 1e-3 (relative Frobenius
   norm); the peak device memory must be below the step's without remat.
10. The same with the one-rank NCCL ``sp_comm`` (ring attention),
   contiguous and then zigzag: no flash launch, 9 layernorm forward and
   backward launches per step, the first loss within 2e-2 of the flash
   path's.
11. The Adam step at the same width: ``make_train_step_optax`` (foreach
   ``torch.optim.Adam`` with optax's defaults) over ``dp_comm`` and
   ``tp_comm``, three steps on one batch, each between launch counts
   (9/9/4/4/4); the same three steps through the plain versions must agree
   in loss and in each parameter's first moment (``ADAM_UPDATE``); then the
   steady step time, tokens/s and peak memory beside the SGD step's, and
   ADAM_SGD_TURNS alternating turns of one synchronised SGD and one Adam
   step (both in the same process state).
12. Checkpoint and resume: after the second Adam step, ``Checkpointer.save``
   of the parameters and ``optimizer.state_dict()`` (704,753,664 bytes of
   f32) into a temporary directory, written in the background, then
   ``wait``; after the live third step, ``restore`` into fresh tensors and a
   fresh optimizer, whose third step must equal the live one in its bits.
   Snapshot, write and restore ms and the bytes on disk are printed; the
   directory is removed.
13. ``moe_ffn`` on 8192 tokens of d_model 1024 and d_ff 4096 (f32, capacity
   1.25, ep 1 over a one-rank NCCL communicator) against
   ``moe_reference_dense`` (``MOE_REL_TOL``), and ``pipeline_apply`` of
   ``t @ w + 1`` (D 1024, 4 microbatches) against the sequential loop.
14. At one rank on CUDA tensors: ``DeviceWindow`` put, get and accumulate,
   a ``DeviceHeap`` put and fetch-add epoch, ``neighbor_allgather`` on a
   periodic (1,) cart, and ``device_pack``/``device_unpack`` of a vector
   type on a 64 MiB tensor against the host convertor, with µs and GB/s.
15. The host plane in this process (``check_host_plane``): a 4-rank
   thread ``LocalUniverse``, then four 4-rank ``TcpProc`` universes in
   threads over loopback: ``tcp`` (``sm=False``: every frame on the
   wire), ``sm`` (the ``sm`` var at its default, one boot id: the
   shared-memory rings carry the data and the wire only the modex),
   ``han`` (``sm_boot_id`` pinned so ranks 0-1 and 2-3 are two emulated
   hosts: ``coll_han_enable=auto`` takes the two-level schedules, intra
   and inter bytes both rise, no flat fallback) and ``numa`` (one boot id,
   ``sm_numa_id`` pinned to two domains of two ranks: allreduce, bcast and
   barrier run three-level).  On each: a barrier, an ``allreduce`` SUM of
   int64 CPU tensors at 1 KiB, 1 MiB and 64 MiB (the last two above
   ``host_coll_large_msg``: the flat planes must take the ring), checked
   exactly against numpy, an ``alltoall``, an ``iallreduce``, a ``bcast``
   and a 4 MiB point-to-point message; rank 0's median µs per call and the
   plane's SPC counters.  ``TcpProc.send`` and ``isend`` of a CUDA tensor
   must raise dss's typed error on every TcpProc plane.  The han plane
   also runs one ``moe_host_ffn`` at the host-moe width (below), experts
   on ``cuda``, held against ``moe_reference_dense`` (``MOE_REL_TOL``)
   with the kept mask equal.  After each plane no ring file, poll thread,
   segment audit failure or han tag window may be left.
16. The host-plane MoE path through its entry point
   (``drive_host_moe_both``), twice: with ``ZMPI_MCA_sm`` unset (the
   default: the rings carry both alltoalls) and with ``ZMPI_MCA_sm=0``
   (all on the loopback wire).  For each this script starts 4 child
   processes of itself, each with the ``ZMPI_*`` coordinator contract
   (this process hosts the rendezvous, ``ZMPI_COORD_EXTERNAL=1``), the
   second job after the first.  Each calls ``zmpi.host_init()``, builds its
   expert on ``cuda`` from a seeded numpy generator, and runs
   ``moe_host_ffn`` at d_model 1024, d_ff 4096, 2048 f32 tokens per rank,
   4 experts, capacity factor 1.25, TF32 off: the median ms of 5 calls,
   then 5 calls split into routing, device-to-host staging, the two
   alltoalls, host-to-device, the expert products (host clock and CUDA
   events) and the combine; the kernels' launch counts over the calls (the
   path launches none of them) and the bytes per call on the rings and on
   the wire.  Rank 0 gathers every rank's ``y`` and ``keep`` over the host
   plane and holds them against ``moe_reference_dense`` over all 8192
   tokens (``MOE_REL_TOL``) and the reference's kept mask.  A child that
   exits non-zero, or prints no result, fails the smoke.
17. Fault tolerance on the card (``drive_ft``): ``FtTrainLoop`` drives
   the flagship width (bf16, batch 16 per rank) on 4 thread ranks of an
   ft ``LocalUniverse`` (ring detector on), each rank with its own batch
   from a seed, a serial ``Checkpointer`` (every 2 steps), an armed
   ``DeviceLivenessProbe`` with the default probe (the real CUDA child)
   and a respawner over ``recovery.respawn_ranks``; its step is
   ``models/ftloop.make_dp_step``: ``loss_fn`` and autograd, the
   gradients flattened into one CUDA tensor, one ``allreduce`` SUM over
   the loop's live window (the ring, on the card), the mean, SGD.  Three
   runs of 6 steps from the same parameters: fault-free; ``kill`` (the
   victim, rank 2, dies at its second point-to-point operation of step
   3's gradient allreduce, ``kill_then_respawn``); ``wedge`` (rank 2's
   device wedges entering step 3, ``wedge_device``: its own probe child
   misses under ``ZMPI_DEVICE_WEDGE``, it classifies ``cause="device"``
   and unwinds, while the survivors' children answer "ok").  Every run
   must end at 4 ranks with every rank's parameters equal in their bits
   to the fault-free run's, survivors with one recovery and the
   replacement with none, both restored at step 2; every attempted rank
   step must launch the kernels 9/9/4/4/4 (the forward kernels by each
   rank thread's own tally, the backward kernels, which autograd's
   device thread launches for every rank, by their total over the run);
   exactly one ``device_faults`` (the victim's) in the wedge run and
   none elsewhere; no detector false positive; and afterwards no
   detector, watchdog, prober or respawn thread nor probe child.
   Printed per run: the median ms of the step's local part and of its
   allreduce, checkpoint ms, the fault-to-classification ms and the
   recovery legs (detect, agree, shrink, rollback, respawn, rejoin; and
   ``recovery.mttr_legs``), the probe children's seconds and the peak
   device memory.  Then the fault-free and kill runs again with one
   ``io/ckptio.CollectiveCheckpointer`` per rank over a shared directory in
   place of the serial ``Checkpointer``s: each save copies only the rank's
   quarter of every leaf to the host and returns; rank 0 (the ranks' one
   locality group's aggregator) writes one replica and commits while the
   next steps run.  Both must end with the fault-free parameters in their
   bits, every rank restored at one step (the kill lands while step 2's
   stream drains, so step 0 or step 2: the newest complete one).  Printed:
   ``save``'s return ms and its stream's drain ms, the bytes written per
   committed checkpoint, ``ckpt_delta_skips`` and
   ``ckpt_async_overlapped``.
18. The process-plane ft job (``drive_ft_processes``): 4 children of
   this script under ``ZMPI_FT=1`` with the sm var at its default (this
   process hosts the rendezvous).  Each stages a CUDA tensor of 2^20
   int64 to the host; rank 3 is killed (``FaultPlan``, then SIGKILL)
   inside the ring allreduce over the rings; the survivors classify it
   (the sm death listener or the transport), ack, agree on the failed
   set, shrink to 3 and reduce exactly against numpy.  The victim's
   ring files are swept as a launcher would (``ZMPI_SESSION``); the
   survivors must leave no ring file, poll thread or detector.  Then the
   same job under the port's ``Dvm`` hosted by this process
   (``drive_ft_dvm``, ``--ft-dvm-child``: the ``ZMPI_PMIX`` contract, the
   heartbeat window of the namesake's DVM drills): after the shrink to 3
   and its exact reduce, the lowest survivor asks the daemon to relaunch
   rank 3 (``recovery.daemon_respawn``), the replacement rejoins through
   the store, and the four reduce exactly on a fresh window.  Gates: one
   respawn counted by the daemon (and one fault event, unless the respawn
   RPC found the corpse still exiting and reaped it itself), no
   namespace, ring file or daemon left.  Printed: the classification ms and cause, the
   respawn RPC ms, the replacement's start-up (imports, CUDA, its
   ``host_init`` with the FT_JOIN) and the respawn-to-rejoin ms.
19. Multi-slice training (``drive_hybrid``): 4 children of this script
   (``--hybrid-child``), one slice each, through ``zmpi.host_init()`` with
   the sm var at its default (this process hosts the rendezvous), each at
   the flagship width (bf16, batch 16 per slice, its own batch from a
   seed) with a one-rank NCCL ``dp_comm``: 3 Adam steps of
   ``make_train_step_optax(dcn_proc=proc)`` (the gradients and loss ride
   one ``hybrid.dcn_grad_sync``: 234,917,888 bytes of f32 per slice and
   step over the rings), then 3 steps of ``parallel/zero.ZeroOptimizer``
   from the same start on the same batches (reduce-scatter, Adam on the
   rank's quarter on the card, allgather).  Gates: each step launches the
   kernels 9/9/4/4/4 in each child; after every step the 4 slices'
   parameters are equal in their bits (blake2b of their bytes); the dcn
   path's first step against one process's Adam step over the 64-sample
   concatenated batch (each parameter's first moment, relative Frobenius
   norm, ``UPDATE_REL_TOL``; the update's difference and the share of
   elements whose update changed sign are printed); ZeRO's updates against
   the dcn path's (``HYBRID_ZERO_REL_TOL``); ZeRO's optimizer state at most
   a quarter of the replicated Adam's plus the last chunk's padding.
   Printed: each path's step ms and its split (local step, device-to-host,
   the host allreduce or reduce-scatter and allgather, host-to-device,
   optimizer), the host-plane bytes sent per rank and step, the peak
   device bytes per rank, the ring bytes, and the phase's seconds.
20. The serving loop (``drive_serve``): the port's ``Dvm`` in this process
   hosts ``--serve-child`` ranks (``ft=True``, ``metrics=True``), each
   ``zmpi.host_init()`` through the store and the flagship at full width
   on the card (bf16, parameters from ``bench.numpy_params(SERVE_SEED)``)
   under ``models/inferloop.FtInferLoop`` (``batch_max`` 16,
   ``respawner=recovery.daemon_respawn``).  A serve step: each live rank
   runs ``transformer.forward`` on its rows of the admitted batch
   (``batch[rank::size]``), scores each row (the mean next-token
   cross-entropy in f32, the last position's argmax) and the rows return
   through one host-plane ``allgather``; rank 0 resolves the tickets.  The
   kill run: 4 ranks, rank 0 submits 64 sequences in 4 bursts of 16;
   rank 2 SIGKILLs itself entering its third forward; the survivors
   requeue the batch, recover, the daemon relaunches rank 2, and the
   replacement, rejoined through the store, receives rank 0's parameters
   (``parallel/hybrid.dcn_bcast_params`` in the loop's ``remesh_fn``) and
   serves.  The elastic run: 2 of 4 slots; rank 0 holds a burst of 32 so
   its published backlog reaches a ``LoadController`` in this process,
   whose ``QueueDepthPolicy`` votes a grow to 4 through the ``metrics``
   RPC; the loop adopts it at a step boundary, the grown ranks receive
   the parameters, and a last burst of 16 is served by 4.  Gates: every
   ticket served once with status ``served`` and each value against this
   process's own forward of the same sequences (``SERVE_CE_TOL``,
   ``SERVE_ARGMAX_TOL``); a requeued ticket and ``infer_requeues``; the
   survivors' cause ``daemon``; the daemon's ``dvm_fault_events`` and
   ``dvm_respawns`` each up by 1 (``dvm_resizes`` by 1 in the elastic
   run); the fleet back at 4; every rank's parameters equal in their bits
   to rank 0's; each forward a rank ran launched 9 layernorm-forward and
   4 flash-forward kernels by its thread's tally and nothing else; no
   namespace, ring file, daemon, serving thread or parked ticket left.
   Printed: rank 0's serve step ms (median, q1-q3, admit to resolve),
   requests/s and tokens/s, the kill-to-classification ms, the recovery
   legs (agree, respawn RPC, the replacement's start-up with the imports
   and the kernel load, its ``host_init`` with the FT_JOIN, the parameters'
   re-broadcast), the requeued tickets' extra latency, the elastic run's
   controller-vote-to-adopted-resize ms, the peak device bytes per rank
   and the phase's seconds.
21. One-sided, PGAS, MPI-IO and dynamic processes (``drive_osc_io``): 4
   children of this script (``--osc-io-child``) through
   ``zmpi.host_init()`` with the sm var at its default (this process hosts
   the rendezvous; ``df /dev/shm`` is printed first), each holding the
   flagship on the card.  Rank 0 makes the f32 parameters from
   ``OSC_SEED`` on the card (234,917,888 bytes) and stages them to the
   host through a pinned buffer; ``osc/direct.allocate_window`` places
   them in an sm RMA region (sized from /dev/shm's free bytes: the
   parameters go in as many ``window_bcast`` calls as the region needs)
   and ``window_bcast`` hands them to ranks 1-3 as direct mapped loads;
   each rank copies them to the card.  Gates: every rank's parameter
   digest is rank 0's; ``osc_direct_bytes`` rises by the payload on each
   pulling rank (twice on rank 0: its store and its own load);
   ``osc_am_fallbacks`` stays 0; the wire and ring bytes during the pull
   stay within ``OSC_CONTROL_BYTES`` (the control bcast).  Then the AM
   contrast: a 16 MiB ``window_bcast`` with ``osc_direct=0`` (exact, no
   direct bytes, the replies carry the payload).  Each rank runs
   ``transformer.forward`` on its 4 rows of a batch of 16 at seq 512
   (exactly 9 layernorm-forward and 4 flash-forward launches by its
   thread's tally), writes its rows' per-token CE (f32, 4 x 512) through a
   ``WireFile`` view at its displacement with ``write_all`` and one record
   through the shared file pointer (``write_shared``); this process reads
   the file back against its own forward of all 16 rows (mean CE and every
   row's mean CE within ``OSC_CE_TOL``; exactly 4 records).  ``shmem_pe``
   picks ``mmap`` for the 4 same-host processes and each rank
   ``atomic_add``s its scored tokens into rank 0's counter (exact at
   16 x 512).  Last, the group ``dpm_wire.spawn``s 2 children
   (``method="spawn"``), which receive the CE file's path by ``bcast``,
   read it with their own ``WireFile.read_all`` and return the sum by
   ``allreduce``: it must equal rank 0's (relative 1e-9).  Printed: a
   ``{"osc_io": ...}`` line with the pull and H2D ms per rank, the AM
   contrast's ms and counters, the CE errors, the PGAS counter, the
   spawn-to-connected ms and the phase's seconds.
22. The tools (``drive_tools``): a port ``Dvm`` in this process;
   ``tools/ztune.sweep`` on its thread harness (the flat topology,
   allreduce and reduce at 4 KiB, 128 KiB and 4 MiB), ``distill``,
   ``check_table`` (exit 0) and ``publish`` into the daemon's store.  Then
   ``tools/mpirun.launch_dvm`` of 4 children of this script
   (``--tools-child traced``, TCP alone, ``metrics=True, trace=True``),
   each the whole flagship on the card with a one-rank tp communicator
   (``coll_monitoring_enable`` on): a PMPI interceptor that counts and
   times every collective by name, an MPI_T ``PvarSession``, one uncounted
   forward, then 3 forwards of its 4 rows of a batch of 16 (exactly 9
   layernorm-forward and 4 flash-forward launches each by its thread's
   tally), the rows' CE ``iallreduce``d and ``iallgather``ed over the host
   plane.  Gates per rank: the interceptor counted exactly the program's
   24 ``allreduce`` calls, the session's ``spc_coll_allreduce_calls``
   delta equals it, ``tcp_posted_recvs`` reads 0 after the last wait,
   ``tuned_table_store_fetches`` >= 1 (the swept table was fetched).
   Rank 0's gathered CE must match this process's forward of all 16 rows
   (mean and every row within ``TOOLS_CE_TOL``).  Each rank runs
   ``ztrace.publish_clock_sync``; rank 0 saves the parameters with
   ``Checkpointer`` at steps 1 and 2.  While the job runs this process
   reads rank 0's ``tcp_bytes_sent`` through ``PvarSession(remote=(dvm,
   job, 0))`` until its delta rises; before releasing the ranks it
   requires a non-empty ``pvars`` table in every metrics snapshot, merges
   the 4 ranks' trace buffers (``ztrace.collect``): no happens-before
   violation, a Chrome trace with one tid per rank, a straggler named for
   each of the 6 collective instances.  Then two plain
   ``mpirun.launch``es side by side: ``names`` (rank 0 publishes an open
   port, rank 3 looks it up and connects; ``--mca tcp_eager_limit 8192``
   reaches every rank) and ``abort`` (the sm var at its default; rank 3
   exits 3: rc 3 within ``TOOLS_ABORT_S`` of its exit, no ring file of the
   session left), beside ``python -m zhpe_ompi_tpu_torch.tools.checkpoint
   list|inspect`` (the flagship's leaf shapes and dtypes) and ``tools.info
   --json`` (lists ``coll/nccl``); then ``checkpoint prune --keep 1``, and
   ``info.gather()``'s pvar count against ``mpit.pvar_get_num()``.  Last,
   ``Communicator.allreduce``'s host µs on a one-rank NCCL communicator
   with no interceptor and with a pass-through one attached (alternating
   turns of 200 calls).  Printed: one ``{"tools": ...}`` line.
23. The native host kernels, the C ABI and ``zmpicc`` (``drive_native``):
   the kernel library ``native/zompi_native.cpp`` and the C ABI shim
   ``native/zompi_mpi.cpp`` are built by ``g++`` into
   ``zhpe_ompi_tpu_torch/csrc/_build/`` beside the CUDA kernels (started
   with them, in a thread; each build's seconds printed); ``tools/zmpicc``
   compiles ``native/feed_c.c``.  One MPMD job under
   ``tools/mpirun.launch_mpmd``: 1 C rank (``feed_c``) beside 4 children of
   this script (``--native-child``, ``host_init`` with sm at its default),
   the 4 sharing the card.  Port rank 1 makes the 16 x 512 token rows (and
   their targets) from the seed with numpy and sends them to the C rank;
   the C rank deals 4 rows to each port rank with ``MPI_Scatterv`` (0 to
   itself); each port rank runs one uncounted and one counted forward of
   the whole flagship on its rows (exactly 9 layernorm-forward and 4
   flash-forward launches, by its thread's tally) and sends its rows' CE
   (f32) through the C rank's ``MPI_Gatherv``; the C rank ``MPI_Bcast``s
   the mean, which every port rank must read bit for bit.  The port ranks
   take their side of the C rank's collectives through
   ``native/cwire.CWorld``.  The mean and every row must match this
   process's forward of all 16 rows within ``NATIVE_CE_TOL``.  Port rank 1
   also times, on the host: the pingpong of two ``TcpProc`` ranks in
   threads (TCP alone) with the native and with the Python matching
   engine at 8 B, 4 KiB and 64 KiB (one-way µs, half a round trip); the
   native pack against the index-map pack of a strided vector over 64 MiB
   (GB/s of packed bytes, equal bytes); ``zompi_reduce`` against the torch
   combine for SUM of 16 Mi float32 (ms, equal bits).  Printed: one
   ``{"native": ...}`` line.
24. Print one ``{"kernels": [...]}`` line (``launches``: per training
   step; ``launches_by_path``: per forward, training, remat, sp, runtime,
   long-context, Adam, ft rank, hybrid, ZeRO, serve step, phase 21's,
   phase 22's and phase 23's forward), the smoke's total seconds, the
   card's line, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, with no result line, when no CUDA
device is present or when the port's package is not beside this script.

    python3 chip_smoke.py --wrapper-host-us PORT_ROOT

prints only the wrappers' host µs per call, and ``Communicator.allreduce``'s,
of the port under PORT_ROOT (for example an older commit unpacked there),
to compare two versions on one card.

    python3 chip_smoke.py --compare-host-us OTHER_ROOT [PAIRS]

runs that measurement for OTHER_ROOT and for the port beside this script
in PAIRS (default 10) alternating pairs of processes (other first in even
pairs, this one first in odd pairs) and prints each version's median and
quartiles of every number.  PORT_ROOT and OTHER_ROOT must hold the port's
``bench.py``, whose headline width the wrappers are timed at.

    python3 chip_smoke.py --host-plane

runs only phases 15 and 16 (no kernel build), printing the card's line
and their results.

    python3 chip_smoke.py --host-moe-child

is phase 16's child (started by the smoke itself, with the ``ZMPI_*``
environment); run alone it fails, as ``host_init`` does without that
contract.

    python3 chip_smoke.py --ft

runs only phases 17 and 18 (after the kernel build); ``--ft-child`` and
``--ft-dvm-child`` are phase 18's children.

    python3 chip_smoke.py --serve

runs only phase 20 (after the kernel build); ``--serve-child kill|elastic``
is its child.

    python3 chip_smoke.py --hybrid

runs only phase 19 (after the kernel build); ``--hybrid-child`` is its
child.

    python3 chip_smoke.py --osc-io

runs only phase 21 (after the kernel build); ``--osc-io-child`` is its
child.

    python3 chip_smoke.py --tools

runs only phase 22 (after the kernel build); ``--tools-child
traced|names|abort`` is its child.

    python3 chip_smoke.py --native

runs only phase 23 (after the kernel build); ``--native-child`` is its
child.

    python3 chip_smoke.py --bench-after

runs every phase, and after phase 14 the bench's remat-off pair once more,
in this process after the profiled phases, beside phase 5's reading.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

_T0 = time.time()  # this process's start, for a rank's start-up legs

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12

# flagship width (bench.py's headline config), its batch per chip and CE
# chunk: main() takes them from the port's own zhpe_ompi_tpu_torch.bench
HEADLINE: dict = {}
BATCH = CE_CHUNK = 0
N_BATCHES = 3
TRAIN_STEPS = 5
STEADY_STEPS = 12
# SGD rate of the smoke's training steps: the JAX package's default 1e-2
# moves the loss of a random-weight model by less per step than bf16
# rounding moves it between two runs of the same step; 0.1 makes five
# steps on one batch a clear fall
TRAIN_LR = 0.1

# Tolerances, each with its reason:
# - layernorm y: kernel and plain version both compute f32 statistics and
#   round y to bf16 once; f32 summation order can move y across one bf16
#   rounding boundary, so allow one bf16 ulp of the largest |y| (2^-7
#   relative covers it).  m and r: f32 sums in another order.
LN_Y_REL_TOL = 2.0 ** -7
LN_STAT_TOL = 1e-4
# - flash out: the kernel rounds the probabilities to bf16 for the P V
#   product (the plain version keeps them f32; relative error 2^-9 of
#   sum p|v|) and both round O to bf16 (one ulp, at most 2^-7 of |O|):
#   two bf16 ulps of the largest |O| (2^-6 relative) cover both.
FLASH_OUT_REL_TOL = 2.0 ** -6
# - flash lse: f32 scores from bf16 products in another summation order.
FLASH_LSE_TOL = 1e-3
# - main path, kernel path vs plain path (fused_ln=False, flash=False):
#   bf16 activations through four layers, rounded at other places.
LOSS_TOL = 2e-2
LOGITS_TOL = 0.1
# - logits product: the same bf16 products accumulated in f32 in another
#   order, over d_model = 1024 terms of logits of order 1
PRODUCT_TOL = 1e-3
LOSS_NEAR_LN_V = 0.5
# - layernorm backward: dx in f32 rounded once (one bf16 ulp of the largest
#   |dx|, or f32 summation order for an f32 x); dg an f32 sum over the rows
#   in another order.
LN_DX_REL_TOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
LN_DG_REL_TOL = 1e-4
# - flash backward: the kernels round p and ds to bf16 for their products
#   (the plain version keeps f32) and round dq, dk, dv to bf16: two bf16
#   ulps of the largest |gradient| (2^-6 relative).
FLASH_BWD_REL_TOL = 2.0 ** -6
# - training step, kernel path vs plain path from the same parameters and
#   batch: the loss as above, and each parameter's update dp (= -lr g) in
#   relative Frobenius norm, |dp_kernel - dp_plain| / |dp_plain|; the two
#   paths round bf16 activations and their gradients at other places
#   (attn_reference rounds the scores and weights to bf16, the kernels do
#   not) through four layers forward and back.  On an H100 the update
#   difference measured at most 0.0101 (embed, ln1, ln2, wqkv and w1 all
#   near 0.01): twice that is the bound.
TRAIN_LOSS_TOL = 2e-2
UPDATE_REL_TOL = 2e-2

# - remat: the same forward, so the same loss; the backward recomputes the
#   same layers, so each parameter's update agrees to f32 summation order
#   (relative Frobenius norm).
REMAT_UPDATE_REL_TOL = 1e-3
# - ring recurrence at (16, 512, 16, 64) bf16 in RING_BLOCKS blocks against
#   one exact block: both in f32 from bf16 inputs, rounded to bf16 once
#   (2^-8 relative of outputs of order 1), summed in another order.
RING_BLOCKS = 4
# rounds of the in-process comparison of allreduce's host cost with and
# without tuned
HOST_US_TURNS = 10
# Adam: counted steps (the checkpoint is taken after the one before last).
# ADAM_UPDATE: the Adam steps are held to the plain path's by their losses
# (TRAIN_LOSS_TOL) and by each parameter's first moment, the running mean of
# the gradients each path computed (UPDATE_REL_TOL, the train phase's bound
# on lr * g).  The parameter update itself is printed, not gated: Adam moves
# each element by about lr * m / sqrt(v), +-lr whatever the gradient's size,
# so an element whose gradient is smaller than the two paths' difference
# moves +lr on one and -lr on the other.  On an H100 the updates after three
# steps differed by 0.043-0.071 (relative Frobenius norm) while the losses
# agreed within 1e-4.
ADAM_STEPS = 3
# turns of the alternating Adam-against-SGD step timing
ADAM_SGD_TURNS = 8
# - moe_ffn at ep 1 against moe_reference_dense: the same f32 products (TF32
#   off), the dispatch path's on a capacity-padded buffer, so cuBLAS may sum
#   the d_model and d_ff terms in another order: 1e-4 of the largest |y|.
MOE_TOKENS = 8192
MOE_REL_TOL = 1e-4
# pipeline_apply: microbatches and their rows (at one stage the pipeline is
# the stage over each microbatch: the same products, compared exactly)
PIPE_M, PIPE_MB = 4, 2048
# device_pack's source tensor (f32), of which a vector type packs half
PACK_BYTES = 64 << 20
# host plane: ranks of the in-process universes, allreduce sizes with the
# calls timed at each, the point-to-point message (above tcp_eager_limit)
HOST_RANKS = 4
HOST_SIZES = {"1KiB": (1 << 10, 10), "1MiB": (1 << 20, 5), "64MiB": (64 << 20, 3)}
# timed calls of the small collectives and of the 4 MiB message per plane
HOST_REPS, HOST_P2P_REPS = 10, 5
HOST_P2P_BYTES = 4 << 20
HOST_TIMEOUT_S = 300.0
# host-plane MoE: ranks (one expert each), tokens per rank, timed calls,
# capacity factor, and the seed of the experts and tokens
HOST_MOE_RANKS = 4
HOST_MOE_TOKENS = 2048
HOST_MOE_CALLS = 5
HOST_MOE_CAPACITY = 1.25
HOST_MOE_SEED = 1808
RING_TOL = 2e-2
# fault tolerance (phases 17 and 18): thread ranks of the ft universe, the
# training steps of each run, the checkpoint cadence, the step (0-based)
# the fault lands in and its victim, the SGD rate, and the seed of the
# plans and the batches.  FT_GUARD_S is the guarded region's deadline (a
# 4-rank step takes well under a second); the probe child's own deadline
# FT_PROBE_DEADLINE_S must outlive its start-up (import torch and a CUDA
# context: 8.42-9.95 s alone on the card's host, PR 6), its outer kill
# FT_PROBE_TIMEOUT_S that.  The heartbeat window FT_DETECTOR_S is wide
# enough that four ranks launching kernels under one interpreter lock never
# starve a heartbeat thread past it (the false-positive gate is zero).
FT_DEVICE = "cuda"
FT_RANKS = 4
FT_STEPS = 6
FT_CKPT_EVERY = 2
FT_FAULT_STEP = 3
FT_VICTIM = 2
FT_LR = TRAIN_LR
FT_SEED = 2029
FT_GUARD_S = 5.0
FT_PROBE_DEADLINE_S = 20.0
FT_PROBE_TIMEOUT_S = 40.0
FT_DETECTOR_PERIOD_S = 0.1
FT_DETECTOR_S = 30.0
FT_RUN_TIMEOUT_S = 300.0
# the kill lands at the victim's second point-to-point operation of the
# gradient allreduce: inside the ring's reduce-scatter, so no survivor can
# finish that step
FT_KILL_AFTER_OPS = 1
# phase 18: the process-plane ft job (ranks, victim, staged int64 elements)
FT_PROC_RANKS = 4
FT_PROC_VICTIM = 3
FT_PROC_ELEMS = 1 << 20

# phase 19, multi-slice training: host_init children (one slice each, on the
# card through one-rank NCCL dp communicators), Adam steps of the dcn path
# and then of ZeroOptimizer from the same start on the same batches, the
# seed of the batches (slice r draws from HYBRID_SEED + r).
HYBRID_DEVICE, HYBRID_BACKEND = "cuda", "nccl"
HYBRID_RANKS = 4
HYBRID_STEPS = 3
HYBRID_SEED = 1919
# - the dcn path's first Adam step against one process's Adam step on the
#   4 slices' concatenated 64-sample batch: each parameter's first moment
#   ((1 - b1) g after one step) in relative Frobenius norm within the train
#   phase's UPDATE_REL_TOL (the two sum the same per-token gradients over
#   other splits of the batch, and cuBLAS may tile the 4x taller products
#   differently).  The update itself is printed, not gated (ADAM_UPDATE:
#   Adam's first step moves each element by about +-lr whatever its
#   gradient's size).
# - ZeroOptimizer against the dcn path after HYBRID_STEPS steps: the same
#   gradients summed over the slices in another order (a reduce to one rank
#   and a scatter against the ring allreduce), the same Adam arithmetic on
#   each element: each parameter's total update in relative Frobenius norm
#   within REMAT_UPDATE_REL_TOL (f32 summation order).
HYBRID_ZERO_REL_TOL = REMAT_UPDATE_REL_TOL

# Phase 18's DVM run and phase 20 (the serving loop), daemon-hosted by the
# port's Dvm in this process:
# - SERVE_REQUESTS sequences of the flagship's seq from SERVE_SEED + 1, in
#   bursts of SERVE_BURST (the loop's batch_max), each scored by the rank
#   that holds its row: the mean next-token cross-entropy (f32) and the
#   last position's argmax.  Held against this process's own forward of the
#   same sequences on the card in batches of SERVE_BURST: the mean CE
#   within SERVE_CE_TOL (the forward phase's LOSS_TOL: bf16 operands with
#   f32 accumulation, where a rank's 4-row products may tile differently
#   from the 16-row ones), the argmax equal unless the reference's logit at
#   the served argmax is within SERVE_ARGMAX_TOL (LOGITS_TOL) of its
#   maximum (a tie within bf16).
# - the kill run: SERVE_RANKS ranks, rank SERVE_VICTIM SIGKILLs itself
#   entering its SERVE_KILL_STEP-th forward; the elastic run starts
#   SERVE_ELASTIC_START of SERVE_RANKS slots, rank 0 submits
#   SERVE_ELASTIC_BURST requests and holds them SERVE_ELASTIC_HOLD_S so the
#   published backlog reaches the controller before the loop serves it.
# - SERVE_MCA: the heartbeat window of the namesake's DVM drills (only the
#   daemon's waitpid classifies a death in time) and a 300 ms publish
#   interval; SERVE_REJOIN_S covers a rank process's start on the card's
#   host (import torch alone took 8-10 s there).
SERVE_DEVICE = "cuda"
SERVE_RANKS = 4
SERVE_REQUESTS = 64
SERVE_BURST = 16
SERVE_SEED = 2112
SERVE_VICTIM = 2
SERVE_KILL_STEP = 3
SERVE_CE_TOL = LOSS_TOL
SERVE_ARGMAX_TOL = LOGITS_TOL
SERVE_ELASTIC_START = 2
SERVE_ELASTIC_BURST = 32
SERVE_ELASTIC_HOLD_S = 1.5
SERVE_JOB_S = 600.0
SERVE_REJOIN_S = 240.0
SERVE_MCA = [("ft_detector_period", "2.0"), ("ft_detector_timeout", "60.0"),
             ("spc_publish_interval_ms", "300")]

# Phase 21 (drive_osc_io): OSC_RANKS host_init children, the flagship on
# the card in each; its parameters from OSC_SEED reach ranks 1-3 by the
# direct RMA window (osc/direct.window_bcast), an OSC_AM_BYTES broadcast with
# osc_direct=0 is the AM contrast, and each rank's OSC_ROWS rows of a batch
# of OSC_BATCH go through the forward, a WireFile, a PGAS counter and
# OSC_SPAWN spawned readers.  OSC_CE_TOL bounds the file's mean CE and each
# row's mean CE against this process's forward of all rows (the serve
# phase's bound: the rows' forward runs at batch 4 in a child, at 16 here);
# OSC_CONTROL_BYTES bounds what a rank sends on the wire and the rings while
# the direct pull runs (the control bcast and barrier).
OSC_DEVICE = "cuda"
OSC_RANKS = 4
OSC_BATCH = 16
OSC_ROWS = OSC_BATCH // OSC_RANKS
OSC_SEED = 2313
OSC_AM_BYTES = 16 << 20
OSC_CE_TOL = LOSS_TOL
OSC_SPAWN = 2
OSC_CONTROL_BYTES = 1 << 20
OSC_TIMEOUT_S = 600.0

# Phase 22 (drive_tools): the port's tools around the flagship forward.
# TOOLS_SWEEP_OPS and TOOLS_SWEEP_SIZES are the ztune sweep of this process
# on its thread harness (the flat topology; the namesake's sweep has
# candidates for allreduce, reduce, alltoall and alltoallv, none for bcast);
# TOOLS_RANKS daemon-hosted children (--tools-child traced) each hold the
# flagship on the card and run TOOLS_FORWARDS counted forwards of their
# TOOLS_ROWS rows of a batch of TOOLS_BATCH through a one-rank tp
# communicator (2 allreduces a layer, through the PMPI interceptor), the
# rows' CE reduced and gathered over the host plane (nonblocking, so each
# collective records a ztrace span); TOOLS_CE_TOL bounds rank 0's gathered
# CE against this process's forward of all rows (phase 21's bound).
# TOOLS_MCA: the traced job on TCP alone (its tcp_bytes_sent is what the
# remote session reads) and the publisher at its 250 ms floor.  The plain
# launches (--tools-child names|abort) forward TOOLS_NAMES_MCA; the abort's
# rc must come within TOOLS_ABORT_S of the rank's exit (the launcher's
# SIGTERM grace is 2 s).  TOOLS_PMPI_TURNS: alternating turns of the PMPI
# host cost, 200 calls each (host_us_per_call).
TOOLS_DEVICE, TOOLS_BACKEND = "cuda", "nccl"
TOOLS_RANKS = 4
TOOLS_BATCH = 16
TOOLS_ROWS = TOOLS_BATCH // TOOLS_RANKS
TOOLS_FORWARDS = 3
TOOLS_SEED = 2414
TOOLS_CE_TOL = LOSS_TOL
TOOLS_SWEEP_OPS = ("allreduce", "reduce")
TOOLS_SWEEP_SIZES = (4 << 10, 128 << 10, 4 << 20)
TOOLS_MCA = [("sm", "0"), ("spc_publish_interval_ms", "250")]
TOOLS_NAMES_MCA = [("tcp_eager_limit", "8192")]
TOOLS_ABORT_S = 3.0
TOOLS_PMPI_TURNS = 4
TOOLS_WAIT_S = 300.0

# Phase 23 (drive_native): the native host kernels, the C ABI and zmpicc.
# One MPMD job: 1 C rank (native/feed_c.c) and NATIVE_RANKS children of this
# script on NATIVE_DEVICE, each the flagship forward on NATIVE_ROWS rows of
# a batch of NATIVE_BATCH (tokens and targets from NATIVE_SEED);
# NATIVE_CE_TOL bounds the C rank's mean and rows against this process's
# forward of all rows (phase 21's bound).  Port rank 1's host timings:
# NATIVE_PINGPONG sizes (bytes, round trips), NATIVE_PACK_BYTES of source
# for the strided pack, NATIVE_REDUCE_ELEMS float32 for the SUM; each the
# best of NATIVE_TURNS.
NATIVE_DEVICE = "cuda"
NATIVE_RANKS = 4
NATIVE_BATCH = 16
NATIVE_ROWS = NATIVE_BATCH // NATIVE_RANKS
NATIVE_SEED = 2515
NATIVE_CE_TOL = LOSS_TOL
NATIVE_PINGPONG = ((8, 400), (4 << 10, 400), (64 << 10, 200))
NATIVE_PACK_BYTES = 64 << 20
NATIVE_REDUCE_ELEMS = 16 << 20
NATIVE_TURNS = 3
NATIVE_TIMEOUT_S = 600.0

# Shapes at the flash kernels' edges, (shape, causal, strided): a long
# sequence, so the ring's mbarrier phases wrap many times (64 key or query
# tiles a block), and an S that is not a multiple of the forward's 128-row
# block nor of the dk/dv kernel's 128-key block.
EDGE_CASES = [((1, 4096, 2, 64), True, False), ((1, 4096, 2, 64), False, False),
              ((2, 192, 3, 64), True, False)]


# device function names of the port's kernels, as the profiler lists them
PORT_KERNELS = ("ln_fwd_", "ln_bwd_", "flash_fwd_kernel", "flash_bwd_dq_kernel",
                "flash_bwd_dkv_kernel")


def _take_widths() -> None:
    """HEADLINE, BATCH and CE_CHUNK from ``zhpe_ompi_tpu_torch.bench`` of
    the port first on ``sys.path``."""
    global HEADLINE, BATCH, CE_CHUNK
    from zhpe_ompi_tpu_torch import bench

    HEADLINE, BATCH, CE_CHUNK = bench.HEADLINE, bench.BATCH, bench.CE_CHUNK


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, n_sets, iters=40, warmup=4) -> float:
    """Mean device time of one call, by CUDA events around ``iters``
    back-to-back calls.  ``fn(i)`` uses input set ``i % n_sets``; the
    caller makes enough sets that together they exceed the 50 MB L2, so
    each call reads its inputs from device memory.  A spin kernel holds the
    device while the host queues the calls, so the events time the
    device's work and not the host's launch rate."""
    for i in range(warmup):
        fn(i % n_sets)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms of device time
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        fn(i % n_sets)
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if host_ms > 40:
        raise SystemExit(f"timing: the host took {host_ms} ms to queue the "
                         "calls, longer than the spin kernel holds the device")
    return start.elapsed_time(end) / iters


def _event_ms(torch, fn, reps=3) -> float:
    """Time of one call by CUDA events around ``reps`` calls after one
    warm-up, with no spin kernel ahead of them: for work that issues many
    small kernels, the time includes the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us_per_call(torch, fn, n_sets, calls=200, reps=3) -> float:
    """Host time of one call in µs: the median over ``reps`` runs of
    ``calls`` back-to-back calls queued while a spin kernel holds the
    device, so the clock reads the wrapper's own cost (checks, tensor maps,
    ctypes, launch) and not the device's work."""
    for i in range(4):
        fn(i % n_sets)
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        torch.cuda._sleep(200_000_000)  # ~100 ms of device time
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i % n_sets)
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    runs.sort()
    return runs[reps // 2]


def wrapper_host_us(torch, fa) -> dict:
    """Host µs per call of the flash forward, dq and dk/dv wrappers at the
    headline shape (16, 512, 16, 64) bf16 causal."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    shape = (BATCH, HEADLINE["seq"], HEADLINE["n_heads"],
             HEADLINE["d_model"] // HEADLINE["n_heads"])
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, True)
    _, delta = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    return {
        "flash_fwd": host_us_per_call(torch, lambda i: fa.flash_fwd(q, k, v, True), 1),
        "flash_bwd_dq": host_us_per_call(
            torch, lambda i: fa.flash_bwd_dq(q, k, v, out, lse, do, True), 1),
        "flash_bwd_dkv": host_us_per_call(
            torch, lambda i: fa.flash_bwd_dkv(q, k, v, lse, delta, do, True), 1),
    }


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_layernorm(torch, F, fused_norm):
    gen = torch.Generator(device="cuda").manual_seed(1)
    n, d = BATCH * HEADLINE["seq"], HEADLINE["d_model"]
    # odd shapes: the register path's masked edge, the generic path, f32
    # ... and the serving shape: one rank's 4 rows of a 16-request batch
    for shape, dtype in (((1000, 1000), torch.bfloat16),
                         ((77, 1001), torch.bfloat16),
                         ((333, 640), torch.float32),
                         ((SERVE_BURST // SERVE_RANKS * HEADLINE["seq"], d),
                          torch.bfloat16),
                         ((n, d), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        g = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        y, m, r = fused_norm.ln_fwd(x, g)
        torch.cuda.synchronize()
        yp, mp, rp = fused_norm.ln_fwd_plain(x, g)
        err = _max_err(y, yp)
        tol = LN_Y_REL_TOL * float(yp.float().abs().max())
        serr = max(_max_err(m, mp), _max_err(r, rp) / float(rp.abs().max()))
        print(f"layernorm {shape} {dtype}: max|y-plain| {err} (tol {tol}), "
              f"stats {serr} (tol {LN_STAT_TOL})")
        if not (err <= tol and serr <= LN_STAT_TOL):
            raise SystemExit(f"layernorm kernel disagrees at {shape} {dtype}")
    g_lib = g.to(x.dtype)
    xs = [x] + [x.clone() for _ in range(3)]  # 4 x 16 MB: more than the L2
    ms = _time_ms(torch, lambda i: fused_norm.ln_fwd(xs[i], g), len(xs))
    plain_ms = _time_ms(torch, lambda i: fused_norm.ln_fwd_plain(xs[i], g), len(xs))
    lib_ms = _time_ms(torch, lambda i: F.layer_norm(xs[i], (d,), g_lib, None, 1e-5),
                      len(xs))
    # a device copy of x into y moves the same 32 MB: the practical ceiling
    ys = [torch.empty_like(t) for t in xs]
    copy_ms = _time_ms(torch, lambda i: ys[i].copy_(xs[i]), len(xs))
    nbytes = 2 * n * d * x.element_size() + d * 4 + 2 * n * 4
    nflop = 8 * n * d  # sum, centre, square, sum, scale, gain (f32 SIMT)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nflop / F32_FLOP_PER_S * 1e3
    return {
        "name": "layernorm_fwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/fused_norm.cu",
        "replaces": "zhpe_ompi_tpu/ops/fused_norm.py:49",
        "shape": [n, d], "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "copy_ms": copy_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }


def check_flash(torch, F, fa):
    gen = torch.Generator(device="cuda").manual_seed(2)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    # odd shapes: ragged S, other head dims, strided views of a fused qkv
    # ... and the serving shape: one rank's 4 rows of a 16-request batch
    cases = [((2, 300, 3, 64), True, False), ((2, 300, 3, 64), False, False),
             ((1, 129, 2, 32), True, False), ((1, 200, 2, 128), True, False),
             ((2, 256, 4, 64), True, True), *EDGE_CASES,
             ((SERVE_BURST // SERVE_RANKS, S, h, hd), True, False),
             ((B, S, h, hd), True, False)]
    for shape, causal, strided in cases:
        if strided:
            b_, s_, h_, d_ = shape
            qkv = rnd(b_, s_, 3, h_ * d_)
            q, k, v = (qkv[:, :, i].reshape(shape) for i in range(3))
        else:
            q, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
        out, lse = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
        err, lerr = _max_err(out, out_p), _max_err(lse, lse_p)
        tol = FLASH_OUT_REL_TOL * float(out_p.float().abs().max())
        print(f"flash {shape} causal={causal} strided={strided}: "
              f"max|o-plain| {err} (tol {tol}), "
              f"max|lse-plain| {lerr} (tol {FLASH_LSE_TOL})")
        if not (err <= tol and lerr <= FLASH_LSE_TOL):
            raise SystemExit(f"flash kernel disagrees at {shape} causal={causal}")
    # 3 sets of q, k, v (48 MB each): more than the L2
    sets = [(q, k, v)] + [tuple(t.clone() for t in (q, k, v)) for _ in range(2)]
    # SDPA takes (B, h, S, hd): the same tensors, viewed
    tsets = [tuple(t.transpose(1, 2) for t in qkv) for qkv in sets]
    ms = _time_ms(torch, lambda i: fa.flash_fwd(*sets[i], True), len(sets))
    plain_ms = _time_ms(torch, lambda i: fa.flash_fwd_plain(*sets[i], True),
                        len(sets), iters=10, warmup=2)
    lib_ms = _time_ms(torch, lambda i: F.scaled_dot_product_attention(
        *tsets[i], is_causal=True), len(sets))
    pairs = B * h * S * (S + 1) // 2  # causal (query, key) pairs this run needs
    nflop = 4 * pairs * hd            # Q K^T and P V, 2 flops per multiply-add
    nbytes = 4 * B * S * h * hd * 2 + B * h * S * 4
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = nflop / BF16_TENSOR_FLOP_PER_S * 1e3
    return {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/flash_attention.cu",
        "replaces": "zhpe_ompi_tpu/ops/flash_attention.py:65",
        "shape": [B, S, h, hd], "dtype": "bfloat16", "causal": True,
        "max_abs_err": err, "tolerance": tol,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": max(bound_bytes, bound_ops),
        "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
    }


def _bound(nbytes, nflop, flop_rate):
    """The least time (ms) the card could take, and what binds it."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nflop / flop_rate * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_layernorm_bwd(torch, fused_norm):
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, d = BATCH * HEADLINE["seq"], HEADLINE["d_model"]
    # ... and the serving shape: one rank's 4 rows of a 16-request batch
    for shape, dtype in (((1000, 1000), torch.bfloat16),
                         ((77, 1001), torch.bfloat16),
                         ((333, 640), torch.float32),
                         ((SERVE_BURST // SERVE_RANKS * HEADLINE["seq"], d),
                          torch.bfloat16),
                         ((n, d), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 2 + 0.5).to(dtype)
        dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        _, m, r = fused_norm.ln_fwd_plain(x, g)
        dx, dg = fused_norm.ln_bwd(x, g, dy, m, r)
        torch.cuda.synchronize()
        dxp, dgp = fused_norm.ln_bwd_plain(x, g, dy, m, r)
        err, gerr = _max_err(dx, dxp), _max_err(dg, dgp)
        tol = LN_DX_REL_TOL[str(dtype).split(".")[-1]] * float(dxp.float().abs().max())
        gtol = LN_DG_REL_TOL * float(dgp.abs().max())
        print(f"layernorm bwd {shape} {dtype}: max|dx-plain| {err} (tol {tol}), "
              f"max|dg-plain| {gerr} (tol {gtol})")
        if not (err <= tol and gerr <= gtol):
            raise SystemExit(f"layernorm backward kernel disagrees at {shape} {dtype}")
    # 3 sets of x and dy (32 MB each): more than the L2
    sets = [(x, dy)] + [(x.clone(), dy.clone()) for _ in range(2)]
    ms = _time_ms(torch, lambda i: fused_norm.ln_bwd(sets[i][0], g, sets[i][1], m, r),
                  len(sets))
    plain_ms = _time_ms(torch, lambda i: fused_norm.ln_bwd_plain(
        sets[i][0], g, sets[i][1], m, r), len(sets))
    g_lib, m2, r2 = g.to(x.dtype), m[:, None], r[:, None]
    lib_ms = _time_ms(torch, lambda i: torch.ops.aten.native_layer_norm_backward(
        sets[i][1], sets[i][0], [d], m2, r2, g_lib, None, [True, True, False]),
        len(sets))
    nbytes = 3 * n * d * x.element_size() + 2 * d * 4 + 2 * n * 4
    nflop = 11 * n * d  # x^, dx^, dg, two row sums, dx (f32 SIMT)
    bound_ms, bound_by = _bound(nbytes, nflop, F32_FLOP_PER_S)
    return {
        "name": "layernorm_bwd", "route": "cuda",
        "source": "zhpe_ompi_tpu_torch/csrc/fused_norm.cu",
        "replaces": "zhpe_ompi_tpu/ops/fused_norm.py:91",
        "shape": [n, d], "dtype": "bfloat16",
        "max_abs_err": err, "tolerance": tol, "dg_max_abs_err": gerr,
        "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "library": "torch.ops.aten.native_layer_norm_backward",
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_flash_bwd(torch, F, fa):
    gen = torch.Generator(device="cuda").manual_seed(4)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    cases = [((2, 300, 3, 64), True, False), ((2, 300, 3, 64), False, False),
             ((1, 129, 2, 32), True, False), ((1, 200, 2, 128), True, False),
             ((3, 70, 2, 16), False, False), ((2, 256, 4, 64), True, True),
             *EDGE_CASES, ((B, S, h, hd), True, False)]
    for shape, causal, strided in cases:
        if strided:
            b_, s_, h_, d_ = shape
            qkv = rnd(b_, s_, 3, h_ * d_)
            q, k, v = (qkv[:, :, i].reshape(shape) for i in range(3))
        else:
            q, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
        do = rnd(*shape)
        out, lse = fa.flash_fwd(q, k, v, causal)
        got = fa.flash_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        want = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
        errs, tols, rels = [], [], []
        for t, w in zip(got, want):
            errs.append(_max_err(t, w))
            tols.append(FLASH_BWD_REL_TOL * float(w.float().abs().max()))
            rels.append(float((t.float() - w.float()).norm() / w.float().norm()))
        print(f"flash bwd {shape} causal={causal} strided={strided}: "
              f"max|d(q,k,v)-plain| {errs} (tol {tols}), relative norm {rels}")
        if not all(e <= t for e, t in zip(errs, tols)):
            raise SystemExit(f"flash backward kernels disagree at {shape} causal={causal}")
    # dq (with delta) and dk/dv sum in a fixed order (no atomics): the same
    # bits twice
    first = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    again = fa.flash_bwd_dq(q, k, v, out, lse, do, True)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"flash dq and delta twice on the same inputs: same bits {deterministic}")
    if not deterministic:
        raise SystemExit("the dq kernel is not deterministic")
    delta = first[1]
    first = fa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    again = fa.flash_bwd_dkv(q, k, v, lse, delta, do, True)
    deterministic = all(torch.equal(a, b) for a, b in zip(first, again))
    print(f"flash dk/dv twice on the same inputs: same bits {deterministic}")
    if not deterministic:
        raise SystemExit("the dk/dv kernel is not deterministic")
    # 2 sets of q, k, v, out, dO (84 MB each): more than the L2
    sets = [(q, k, v, out, lse, do)] + [
        tuple(t.clone() for t in (q, k, v, out, lse, do)) for _ in range(1)]
    deltas = [fa.flash_bwd_dq(*st)[1] for st in sets]
    dq_ms = _time_ms(torch, lambda i: fa.flash_bwd_dq(*sets[i], True), len(sets))
    dkv_ms = _time_ms(torch, lambda i: fa.flash_bwd_dkv(
        *sets[i][:3], sets[i][4], deltas[i], sets[i][5], True), len(sets))
    plain_ms = _time_ms(torch, lambda i: fa.flash_bwd_plain(*sets[i], True),
                        len(sets), iters=6, warmup=2)
    # library yardstick: the backward alone of SDPA (is_causal, flash
    # backend) through autograd, on a graph kept from one forward per set
    graphs = []
    for st in sets:
        tq = [t.transpose(1, 2).detach().requires_grad_() for t in st[:3]]
        graphs.append((F.scaled_dot_product_attention(*tq, is_causal=True), tq,
                       st[5].transpose(1, 2)))
    lib_ms = _time_ms(torch, lambda i: torch.autograd.grad(
        graphs[i][0], graphs[i][1], graphs[i][2], retain_graph=True), len(sets))
    print(f"flash bwd {(B, S, h, hd)} causal: dq {dq_ms * 1e3} us + dk/dv "
          f"{dkv_ms * 1e3} us = pair {(dq_ms + dkv_ms) * 1e3} us, SDPA backward "
          f"{lib_ms * 1e3} us")
    pairs = B * h * S * (S + 1) // 2  # causal (query, key) pairs this run needs
    elems = B * S * h * hd
    rows = B * h * S
    common = {"route": "cuda", "source": "zhpe_ompi_tpu_torch/csrc/flash_attention_bwd.cu",
              "shape": [B, S, h, hd], "dtype": "bfloat16", "causal": True,
              "plain_ms": plain_ms, "plain": "flash_bwd_plain (dq, dk and dv together)",
              "library_ms": lib_ms,
              "library": "autograd backward of F.scaled_dot_product_attention "
                         "(is_causal), dq, dk and dv together"}
    # dq: reads q, k, v, O, dO, lse; writes dq and delta; 3 products
    dq_bound, dq_by = _bound(6 * elems * 2 + 2 * rows * 4, 3 * 2 * pairs * hd,
                             BF16_TENSOR_FLOP_PER_S)
    # dk/dv: reads q, k, v, dO, lse, delta; writes dk, dv; 4 products
    dkv_bound, dkv_by = _bound(6 * elems * 2 + 2 * rows * 4, 4 * 2 * pairs * hd,
                               BF16_TENSOR_FLOP_PER_S)
    return [
        dict(common, name="flash_attention_bwd_dq",
             replaces="zhpe_ompi_tpu/ops/flash_attention.py:214",
             max_abs_err=errs[0], tolerance=tols[0], ms=dq_ms,
             bound_ms=dq_bound, bound_by=dq_by),
        dict(common, name="flash_attention_bwd_dkv",
             replaces="zhpe_ompi_tpu/ops/flash_attention.py:248",
             max_abs_err=max(errs[1:]), tolerance=min(tols[1:]), ms=dkv_ms,
             bound_ms=dkv_bound, bound_by=dkv_by),
    ]


def steady_times(torch, tfm, params, cfg, tp_comm, tokens, targets, reps=20):
    """Host-clock times of ``forward`` and ``loss_fn`` on one batch after
    warm-up, each call ended by a synchronize: median, quartiles, extremes
    over ``reps`` calls, and the scoring rate at the median."""
    out = {}
    calls = {"forward": lambda: tfm.forward(params, tokens, cfg, tp_comm=tp_comm),
             "loss_fn": lambda: tfm.loss_fn(params, tokens, targets, cfg,
                                            tp_comm=tp_comm)}
    with torch.inference_mode():
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            ms = []
            for _ in range(reps):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            ms.sort()
            out[name] = {"reps": reps, "median_ms": ms[reps // 2],
                         "q1_ms": ms[reps // 4], "q3_ms": ms[3 * reps // 4],
                         "min_ms": ms[0], "max_ms": ms[-1],
                         "tokens_per_s": BATCH * cfg.seq / (ms[reps // 2] / 1e3)}
    return out


def profile_calls(torch, call, reps=3):
    """Device time by kernel over ``reps`` calls of ``call()``, from
    torch.profiler (CUPTI), and the device's busy share of the wall time
    (one stream, so kernel times do not overlap).  The profiler's own cost
    is in the wall time, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, host_ops = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = evt.self_cuda_time_total
            kernels.append((us / 1e3 / reps, evt.count / reps, evt.key))
        else:
            host_ops.append((evt.self_cpu_time_total / 1e3 / reps,
                             evt.count / reps, evt.key))
    kernels.sort(reverse=True)
    host_ops.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return {
        "wall_ms_per_call": wall_s * 1e3 / reps,
        "device_ms_per_call": busy_ms,
        "busy_share": busy_ms / (wall_s * 1e3 / reps),
        "top_kernels_ms_per_call": [[k[2][:90], k[0], k[1]] for k in kernels[:16]],
        # the port's own kernels, wherever they rank
        "port_kernels_ms_per_call": [[k[2][:90], k[0], k[1]] for k in kernels
                                     if any(n in k[2] for n in PORT_KERNELS)],
        # host time by operator (self time, profiler cost included)
        "top_host_ops_ms_per_call": [[k[2][:60], k[0], k[1]] for k in host_ops[:12]],
    }


def drive_main_path(torch, np, tfm, fused_ce, fused_norm, fa, tp_comm):
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    plain_cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK,
                           fused_ln=False, flash=False)
    from zhpe_ompi_tpu_torch.bench import numpy_params

    params = tfm.params_from_numpy(numpy_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                rng.integers(0, cfg.vocab, (BATCH, cfg.seq)))
               for _ in range(N_BATCHES)]
    results = []
    counted = _kernel_counters(fused_norm, fa)
    for fn in counted.values():
        fn.launches = 0
    with torch.inference_mode():
        for tokens, targets in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = tfm.forward(params, tokens, cfg, tp_comm=tp_comm)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = tfm.loss_fn(params, tokens, targets, cfg, tp_comm=tp_comm)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            results.append((logits, float(loss), t1 - t0, t2 - t1))
    launches = {name: fn.launches for name, fn in counted.items()}
    n_forward = 2 * N_BATCHES
    want = {"layernorm_fwd": (2 * cfg.n_layers + 1) * n_forward,
            "layernorm_bwd": 0, "flash_attention_fwd": cfg.n_layers * n_forward,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    print(f"main path launches {launches}, expected {want} "
          f"({n_forward} forwards)")
    if launches != want:
        raise SystemExit("the main path did not launch every kernel as expected")

    card = torch.cuda.get_device_name(0)
    for i, (logits, loss, t_fwd, t_loss) in enumerate(results):
        shape_ok = tuple(logits.shape) == (BATCH, cfg.seq, cfg.vocab)
        finite = bool(torch.isfinite(logits).all()) and math.isfinite(loss)
        print(f"batch {i}: loss {loss} forward {t_fwd * 1e3} ms "
              f"loss_fn {t_loss * 1e3} ms "
              f"({BATCH * cfg.seq / t_loss} tokens/s scored) on {card}")
        if not (shape_ok and finite and abs(loss - math.log(cfg.vocab)) < LOSS_NEAR_LN_V):
            raise SystemExit(f"batch {i}: bad output (shape {tuple(logits.shape)}, "
                             f"loss {loss})")

    tokens, targets = batches[0]
    with torch.inference_mode():
        plain_logits = tfm.forward(params, tokens, plain_cfg, tp_comm=tp_comm)
        plain_loss = float(tfm.loss_fn(params, tokens, targets, plain_cfg,
                                       tp_comm=tp_comm))
    lerr = abs(results[0][1] - plain_loss)
    gerr = _max_err(results[0][0], plain_logits)
    print(f"kernel path vs plain path: |loss diff| {lerr} (tol {LOSS_TOL}), "
          f"max|logits diff| {gerr} (tol {LOGITS_TOL})")
    if not (lerr <= LOSS_TOL and gerr <= LOGITS_TOL):
        raise SystemExit("kernel path disagrees with the plain path")
    # the logits product (bf16 operands, f32 result) against both
    # operands upcast to f32 first
    with torch.inference_mode():
        hidden = tfm.forward_hidden(params, tokens, cfg, tp_comm=tp_comm)
        emb = params["embed"].to(cfg.dtype)
        lg = fused_ce._logits(hidden, emb)
        lg_f32 = hidden.float() @ emb.float().t()
    perr = _max_err(lg, lg_f32)
    print(f"logits product vs f32 product: max|diff| {perr} "
          f"(tol {PRODUCT_TOL})")
    if lg.dtype != torch.float32 or not perr <= PRODUCT_TOL:
        raise SystemExit("the f32-result logits product disagrees")
    steady = steady_times(torch, tfm, params, cfg, tp_comm, tokens, targets)
    print(json.dumps({"steady_state": steady, "card": card}))

    def score():
        with torch.inference_mode():
            tfm.loss_fn(params, tokens, targets, cfg, tp_comm=tp_comm)

    prof = profile_calls(torch, score)
    print(json.dumps({"profile_loss_fn": prof, "card": card}))
    return launches, [r[2] for r in results], [r[3] for r in results]


def _kernel_counters(fused_norm, fa):
    return {"layernorm_fwd": fused_norm.ln_fwd, "layernorm_bwd": fused_norm.ln_bwd,
            "flash_attention_fwd": fa.flash_fwd,
            "flash_attention_bwd_dq": fa.flash_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_bwd_dkv}


def train_steps(torch, step, params, tokens, targets, counted, want, label):
    """TRAIN_STEPS steps on one batch, each between launch counts set to 0
    just before and read just after; fails unless every count is as
    ``want`` says and the loss falls with finite values.  The trained
    parameters come back in a dict that no one else references, so that
    ``steady_steps`` can replace them step by step and the peak memory it
    reads holds one live set."""
    card = torch.cuda.get_device_name(0)
    losses = []
    for i in range(TRAIN_STEPS):
        for fn in counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, loss = step(params, tokens, targets)
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        print(f"{label} step {i}: loss {loss} in {dt * 1e3} ms, launches "
              f"{launches} (expected {want}) on {card}")
        if launches != want:
            raise SystemExit(f"a {label} step did not launch the kernels as expected")
        losses.append(loss)
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if not (all(math.isfinite(x) for x in losses) and finite and losses[-1] < losses[0]):
        raise SystemExit(f"{label}: the loss did not fall with finite values: {losses}")
    return {"params": params}, losses, launches


def steady_steps(torch, step, state, tokens, targets, label):
    """Synchronised steps after two warm-up steps: the step time's median
    and quartiles, tokens trained per second, the peak device memory over
    the steady steps, and a torch.profiler breakdown of two steps.
    ``state["params"]`` is replaced by each step's result: the caller
    holds no other reference to it."""
    card = torch.cuda.get_device_name(0)

    def one_step():
        state["params"], _ = step(state["params"], tokens, targets)

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(STEADY_STEPS):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    ms.sort()
    n = len(ms)
    steady = {"steps": n, "median_ms": ms[n // 2], "q1_ms": ms[n // 4],
              "q3_ms": ms[3 * n // 4], "min_ms": ms[0], "max_ms": ms[-1],
              "tokens_per_s_trained": BATCH * HEADLINE["seq"] / (ms[n // 2] / 1e3),
              "max_memory_allocated_bytes": peak}
    prof = profile_calls(torch, one_step, reps=2)
    steady["busy_share"] = prof["busy_share"]
    steady["device_ms_per_step"] = prof["device_ms_per_call"]
    print(json.dumps({f"{label}_steady_state": steady, "card": card}))
    print(json.dumps({f"profile_{label}_step": prof, "card": card}))
    return steady


def _step_launches(cfg) -> dict:
    """The launches of one training step of ``cfg`` on the kernel path:
    the layernorm kernels 2L + 1 times, each flash kernel L times."""
    L = cfg.n_layers
    return {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}


def _train_inputs(torch, np, tfm, cfg, batch=None):
    from zhpe_ompi_tpu_torch.bench import numpy_params

    batch = BATCH if batch is None else batch
    params0 = tfm.params_from_numpy(numpy_params(cfg, seed=0), cfg)
    rng = np.random.default_rng(2)
    tokens, targets = (torch.as_tensor(rng.integers(0, cfg.vocab, (batch, cfg.seq)),
                                       device="cuda") for _ in range(2))
    return params0, tokens, targets


def _update_rel(params0, new_a, new_b):
    """Relative Frobenius difference of two updates of each parameter."""
    return {name: float((new_a[name] - p0 - (new_b[name] - p0)).norm()
                        / (new_b[name] - p0).norm())
            for name, p0 in params0.items()}


def drive_train(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm):
    """The training path: make_train_step at the headline width."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    plain_step, _ = tfm.make_train_step(
        replace(cfg, fused_ln=False, flash=False), dp_comm, tp_comm, lr=TRAIN_LR)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    want = _step_launches(cfg)
    state, losses, launches = train_steps(torch, step, params0, tokens, targets,
                                          counted, want, "train")

    # one step on each path from the same parameters and batch
    new_k, loss_k = step(params0, tokens, targets)
    new_p, loss_p = plain_step(params0, tokens, targets)
    lerr = abs(float(loss_k) - float(loss_p))
    rel = _update_rel(params0, new_k, new_p)
    print(f"train step, kernel path vs plain path: |loss diff| {lerr} "
          f"(tol {TRAIN_LOSS_TOL}), relative update difference {rel} "
          f"(tol {UPDATE_REL_TOL})")
    if not (lerr <= TRAIN_LOSS_TOL and all(r <= UPDATE_REL_TOL for r in rel.values())):
        raise SystemExit("the kernel path's training step disagrees with the plain path")
    del new_k, new_p
    print(json.dumps({"losses": losses, "lr": TRAIN_LR}))
    steady = steady_steps(torch, step, state, tokens, targets, "train")
    return launches, steady, float(loss_k)


def drive_remat(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, train_steady):
    """The training path with ``remat=True``: each layer checkpointed,
    the projections' outputs kept, the rest (both forward kernels
    included) recomputed in the backward."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(replace(cfg, remat=True), dp_comm, tp_comm,
                                  lr=TRAIN_LR)
    base_step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 4 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    state, losses, launches = train_steps(torch, step, params0, tokens, targets,
                                          counted, want, "remat")
    # the first step against the step without remat, same params and batch:
    # the forward is the same computation, so the same loss bits
    new_r, loss_r = step(params0, tokens, targets)
    new_b, loss_b = base_step(params0, tokens, targets)
    loss_r, loss_b = float(loss_r), float(loss_b)
    rel = _update_rel(params0, new_r, new_b)
    print(f"remat step vs step without remat: loss {loss_r} vs {loss_b} "
          f"(difference {loss_r - loss_b}), relative update difference {rel} "
          f"(tol {REMAT_UPDATE_REL_TOL})")
    if loss_r != loss_b:
        print("remat: the first step's loss differs in its bits from the step "
              "without remat")
    if not all(r <= REMAT_UPDATE_REL_TOL for r in rel.values()):
        raise SystemExit("the remat step's update disagrees with the step without remat")
    del new_r, new_b
    print(json.dumps({"remat_losses": losses, "first_loss": loss_r,
                      "first_loss_without_remat": loss_b}))
    steady = steady_steps(torch, step, state, tokens, targets, "remat")
    peak, base_peak = (steady["max_memory_allocated_bytes"],
                       train_steady["max_memory_allocated_bytes"])
    print(f"remat: step median {steady['median_ms']} ms (without remat "
          f"{train_steady['median_ms']} ms), peak memory {peak} bytes (without "
          f"remat {base_peak} bytes), launches per step {launches}")
    if not peak < base_peak:
        raise SystemExit("remat did not lower the training step's peak memory")
    return launches, steady


def drive_sp(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, sp_comm, flash_loss):
    """The training path with a one-rank NCCL ``sp_comm``: attention is ring
    attention (at one rank, one exact block), contiguous then zigzag."""
    from dataclasses import replace

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    counted = _kernel_counters(fused_norm, fa)
    L = cfg.n_layers
    want = {"layernorm_fwd": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}
    out = {}
    for zigzag in (False, True):
        label = "sp_zigzag" if zigzag else "sp_contiguous"
        step, _ = tfm.make_train_step(replace(cfg, zigzag_sp=zigzag), dp_comm,
                                      tp_comm, sp_comm, lr=TRAIN_LR)
        params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
        state, losses, launches = train_steps(
            torch, step, params0, tokens, targets, counted, want, label)
        lerr = abs(losses[0] - flash_loss)
        print(f"{label}: first loss {losses[0]} vs the flash path's {flash_loss}: "
              f"|diff| {lerr} (tol {TRAIN_LOSS_TOL})")
        if not lerr <= TRAIN_LOSS_TOL:
            raise SystemExit(f"{label}: the loss disagrees with the flash path")
        steady = steady_steps(torch, step, state, tokens, targets, label)
        out[label] = (launches, steady)
    return out


def _adam_steps(torch, step, params, opt, tokens, targets, n, counted=None, want=None,
                label="adam"):
    """``n`` Adam steps (in place), each between launch counts set to 0 just
    before and read just after when ``counted`` is given; the losses and the
    last step's launches."""
    losses, launches = [], None
    for i in range(n):
        if counted is not None:
            for fn in counted.values():
                fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        loss = float(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if counted is not None:
            launches = {name: fn.launches for name, fn in counted.items()}
            print(f"{label} step: loss {loss} in {dt * 1e3} ms, launches {launches} "
                  f"(expected {want})")
            if launches != want:
                raise SystemExit(f"an {label} step did not launch the kernels as expected")
        losses.append(loss)
    return losses, launches


def _turns_vs_sgd(torch, tfm, cfg, dp_comm, tp_comm, adam_step, params, params0, tokens,
                  targets, card_line):
    """The Adam step against the SGD step in ADAM_SGD_TURNS alternating turns
    (SGD first in even turns), each step synchronised: both read the same
    host and the same process history, which the steady phases, run at
    other times, do not."""
    sgd_step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    state = {"sgd": {k: v.clone() for k, v in params0.items()}, "adam": params}
    steps = {"sgd": sgd_step, "adam": adam_step}
    ms = {"sgd": [], "adam": []}
    for name in ("sgd", "adam"):  # warm-up
        state[name], _ = steps[name](state[name], tokens, targets)
    for i in range(ADAM_SGD_TURNS):
        for name in (("sgd", "adam") if i % 2 == 0 else ("adam", "sgd")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state[name], _ = steps[name](state[name], tokens, targets)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
    ratios = sorted(a / b for a, b in zip(ms["adam"], ms["sgd"]))
    out = {"sgd": _quartiles(ms["sgd"]), "adam": _quartiles(ms["adam"]),
           "adam_over_sgd_median": ratios[len(ratios) // 2], "ratios": ratios}
    print(json.dumps({"adam_vs_sgd_turns": out, "card": card_line}))
    return out


def drive_adam(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, train_steady, card_line):
    """The Adam step (``make_train_step_optax``, torch.optim.Adam with optax's
    defaults) at the headline width: ADAM_STEPS counted steps, a checkpoint
    of the parameters and optimizer state after step 2 restored into fresh
    tensors whose step 3 must equal the live step 3 in its bits, the same
    steps through the plain versions, then steady steps."""
    from dataclasses import replace

    from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    init, step, _ = tfm.make_train_step_optax(cfg, dp_comm, tp_comm)
    pinit, plain_step, _ = tfm.make_train_step_optax(
        replace(cfg, fused_ln=False, flash=False), dp_comm, tp_comm)
    params0, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    counted = _kernel_counters(fused_norm, fa)
    want = _step_launches(cfg)
    params = {k: v.clone() for k, v in params0.items()}
    opt = init(params)
    losses, _ = _adam_steps(torch, step, params, opt, tokens, targets, ADAM_STEPS - 1,
                            counted, want)
    # the checkpoint after step ADAM_STEPS - 1, written in the background
    with tempfile.TemporaryDirectory() as ckdir:
        ck = Checkpointer(ckdir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save(ADAM_STEPS - 1, {"params": params, "opt": opt.state_dict()})
        t1 = time.perf_counter()
        ck.wait()
        t2 = time.perf_counter()
        step_dir = os.path.join(ckdir, f"step_{ADAM_STEPS - 1}")
        disk = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        more, launches = _adam_steps(torch, step, params, opt, tokens, targets, 1,
                                     counted, want)
        losses += more
        t3 = time.perf_counter()
        state, at = ck.restore(placements={"params": "cuda", "opt": "cpu"})
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    fresh = state["params"]
    fresh_opt = init(fresh)
    fresh_opt.load_state_dict(state["opt"])
    resumed, _ = _adam_steps(torch, step, fresh, fresh_opt, tokens, targets, 1)
    same = resumed[0] == losses[-1] and all(torch.equal(fresh[k], params[k]) for k in params)
    ckpt = {"snapshot_ms": (t1 - t0) * 1e3, "write_ms": (t2 - t1) * 1e3,
            "restore_ms": (t4 - t3) * 1e3, "bytes_on_disk": disk, "step": at,
            "resumed_loss": resumed[0], "live_loss": losses[-1], "bits_equal": same}
    print(json.dumps({"checkpoint": ckpt, "card": card_line}))
    if not same:
        raise SystemExit("the step resumed from the checkpoint differs from the live step")
    del fresh, fresh_opt, state

    # the same steps through the plain versions, from the same parameters
    plain = {k: v.clone() for k, v in params0.items()}
    plain_opt = pinit(plain)
    plain_losses, _ = _adam_steps(torch, plain_step, plain, plain_opt, tokens, targets,
                                  ADAM_STEPS)
    lerr = max(abs(a - b) for a, b in zip(losses, plain_losses))
    rel = _update_rel(params0, params, plain)
    m_rel = {name: float((opt.state[p]["exp_avg"] - plain_opt.state[plain[name]]["exp_avg"])
                         .norm() / plain_opt.state[plain[name]]["exp_avg"].norm())
             for name, p in params.items()}
    print(f"adam, kernel path vs plain path over {ADAM_STEPS} steps: losses {losses} vs "
          f"{plain_losses} (max |diff| {lerr}, tol {TRAIN_LOSS_TOL}), relative first-"
          f"moment difference {m_rel} (tol {UPDATE_REL_TOL}), relative update difference "
          f"{rel} (not gated: see ADAM_UPDATE)")
    finite = all(bool(torch.isfinite(p).all()) for p in params.values())
    if not (finite and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"adam: the loss did not fall with finite values: {losses}")
    if not (lerr <= TRAIN_LOSS_TOL and all(r <= UPDATE_REL_TOL for r in m_rel.values())):
        raise SystemExit("the kernel path's Adam steps disagree with the plain path")
    del plain, plain_opt

    def adam_step(p, tok, tgt):
        p, _, loss = step(p, opt, tok, tgt)
        return p, loss

    steady = steady_steps(torch, adam_step, {"params": params}, tokens, targets, "adam")
    steady["turns_vs_sgd"] = _turns_vs_sgd(torch, tfm, cfg, dp_comm, tp_comm, adam_step,
                                           params, params0, tokens, targets, card_line)
    moments = 2 * sum(p.numel() * p.element_size() for p in params0.values())
    print(f"adam: step median {steady['median_ms']} ms (SGD {train_steady['median_ms']} "
          f"ms), peak {steady['max_memory_allocated_bytes']} bytes (SGD "
          f"{train_steady['max_memory_allocated_bytes']} + moments {moments} = "
          f"{train_steady['max_memory_allocated_bytes'] + moments}) on {card_line}")
    return launches, steady, ckpt, {"losses": losses, "plain_losses": plain_losses,
                                    "exp_avg_rel": m_rel, "update_rel": rel}


def check_moe_pipeline(torch, np, comm, card_line):
    """``moe_ffn`` on MOE_TOKENS tokens of the headline d_model and d_ff at
    capacity 1.25 and ep = 1, against ``moe_reference_dense``; then
    ``pipeline_apply`` of ``t @ w + 1`` over PIPE_M microbatches at D =
    d_model against the sequential loop."""
    from zhpe_ompi_tpu_torch.models import moe, pipeline

    D, F = HEADLINE["d_model"], HEADLINE["d_ff"]
    rng = np.random.default_rng(8)
    prm = moe.moe_params_from_numpy({
        "router": rng.standard_normal((D, 1)) * D ** -0.5,
        "w_in": rng.standard_normal((1, D, F)) * D ** -0.5,
        "w_out": rng.standard_normal((1, F, D)) * F ** -0.5}, ep_rank=0)
    x = torch.as_tensor(rng.standard_normal((MOE_TOKENS, D)), dtype=torch.float32,
                        device="cuda")
    y, keep = moe.moe_ffn(comm, prm, x, capacity_factor=1.25)
    cap = max(1, int(1.25 * MOE_TOKENS))
    dense = moe.moe_reference_dense(prm, x, 1, cap)
    err = _max_err(y, dense) / float(dense.abs().max())
    res = {"moe_ms": _event_ms(torch, lambda: moe.moe_ffn(comm, prm, x, 1.25), reps=5),
           "dense_ms": _event_ms(torch, lambda: moe.moe_reference_dense(prm, x, 1, cap),
                                 reps=5),
           "moe_rel_err": err, "kept": int(keep.sum())}
    if not (err <= MOE_REL_TOL and res["kept"] == MOE_TOKENS and bool(torch.isfinite(y).all())):
        raise SystemExit(f"moe_ffn disagrees with moe_reference_dense: {res}")
    w = torch.as_tensor(rng.standard_normal((1, D, D)) * D ** -0.5, dtype=torch.float32,
                        device="cuda")
    xs = torch.as_tensor(rng.standard_normal((PIPE_M, PIPE_MB, D)), dtype=torch.float32,
                         device="cuda")
    stage = lambda ww, t: t @ ww[0] + 1.0  # noqa: E731
    out = pipeline.pipeline_apply(comm, stage, w, xs)
    seq = torch.stack([t @ w[0] + 1.0 for t in xs])
    res["pipeline_ms"] = _event_ms(torch, lambda: pipeline.pipeline_apply(comm, stage, w, xs),
                                   reps=5)
    res["pipeline_equal"] = torch.equal(out, seq)
    print(json.dumps({"moe_pipeline": res, "card": card_line}))
    if not res["pipeline_equal"]:
        raise SystemExit("pipeline_apply disagrees with the sequential loop")
    return res


def check_device_plane(torch, np, comm, card_line):
    """At one rank on CUDA tensors: DeviceWindow put, get and accumulate; a
    DeviceHeap put and fetch-add epoch; neighbor_allgather on a periodic
    (1,) cart; device_pack and device_unpack of a vector type on a tensor
    of PACK_BYTES against the host convertor, with µs and GB/s."""
    from zhpe_ompi_tpu_torch import datatype as dt
    from zhpe_ompi_tpu_torch import topo
    from zhpe_ompi_tpu_torch.datatype import convertor
    from zhpe_ompi_tpu_torch.osc import DeviceWindow
    from zhpe_ompi_tpu_torch.shmem import spml

    res = {}
    win = DeviceWindow(comm, torch.zeros(1 << 20, device="cuda"))
    vals = torch.arange(16, dtype=torch.float32, device="cuda")
    win = win.put(vals, [0], [100]).fence()
    got = win.get([0], [100], count=16)
    win = win.accumulate(vals, [0], [100])
    res["window"] = (torch.equal(got, vals)
                     and torch.equal(win.shard[100:116], 2 * vals)
                     and float(win.shard.sum()) == float(2 * vals.sum()))
    heap = spml.shmem_pe(comm, heap_bytes=1 << 12)
    sym = heap.shmalloc(2, torch.float32)

    def prog(pe, _):
        pe = pe.local_set(sym, float(pe.my_pe()) + 5.0).barrier()
        pe = pe.put(sym, torch.full((2,), 3.0, device="cuda"), pe_of=lambda r, n: (r + 1) % n)
        old, pe = pe.fadd(sym, 1.0, pe_of=lambda r, n: (r + 1) % n, index=0)
        return pe, old[None]

    old = heap.epoch(prog, torch.zeros((1, 1), device="cuda"))
    res["heap"] = heap.read(sym).tolist() == [[4.0, 3.0]] and old.tolist() == [[3.0]]
    heap.finalize()
    cart = topo.CartTopology(comm, (1,), periods=(True,))
    x = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3)
    nb = topo.neighbor_allgather(cart, x)
    res["neighbor"] = tuple(nb.shape) == (2, 2, 3) and torch.equal(nb[0], x) \
        and torch.equal(nb[1], x)
    # a vector type tiling the buffer: 2 blocks of 2 floats, stride 4, an
    # instance every 8 floats (half the bytes are packed)
    vec = dt.create_resized(dt.create_vector(2, 2, 4, dt.FLOAT), 0, 32).commit()
    n = PACK_BYTES // 4
    count = n // 8
    gen = torch.Generator(device="cuda").manual_seed(9)
    src = torch.randn(n, generator=gen, device="cuda")
    packed = convertor.device_pack(src, vec, count)
    host = convertor.pack(src.cpu().numpy(), vec, count)
    same_pack = bool((packed.cpu().numpy().view(np.uint8) == host).all())
    out = torch.zeros_like(src)
    convertor.device_unpack(packed, vec, count, out)
    want = np.zeros(n, np.float32)
    convertor.unpack(host, vec, count, out=want)
    same_unpack = bool((out.cpu().numpy() == want).all())
    moved = 2 * packed.numel() * packed.element_size()  # read once, written once
    pack_ms = _event_ms(torch, lambda: convertor.device_pack(src, vec, count), reps=20)
    unpack_ms = _event_ms(torch, lambda: convertor.device_unpack(packed, vec, count, out),
                          reps=20)
    res["pack"] = {"source_bytes": n * 4, "packed_bytes": packed.numel() * 4,
                   "pack_us": pack_ms * 1e3, "pack_gb_per_s": moved / pack_ms / 1e6,
                   "unpack_us": unpack_ms * 1e3, "unpack_gb_per_s": moved / unpack_ms / 1e6,
                   "equal_to_host_pack": same_pack, "equal_to_host_unpack": same_unpack}
    print(json.dumps({"device_plane": res, "card": card_line}))
    if not (res["window"] and res["heap"] and res["neighbor"] and same_pack and same_unpack):
        raise SystemExit(f"the device plane at one rank gave a wrong result: {res}")
    return res


def _in_threads(n, fn, timeout):
    """fn(r) in n threads; the results by rank, or the first error."""
    import threading

    results, excs = [None] * n, [None] * n

    def main(r):
        try:
            results[r] = fn(r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            excs[r] = e

    threads = [threading.Thread(target=main, args=(r,), daemon=True) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise SystemExit("host plane: a rank hung")
    for e in excs:
        if e is not None:
            raise e
    return results


def _tcp_run(n, prog, timeout, kwargs_by_rank=None):
    """prog(proc) on an n-rank TcpProc universe in threads over loopback;
    rank 0 binds the coordinator on port 0.  ``kwargs_by_rank[r]`` are
    rank r's constructor overrides (``sm``, ``sm_boot_id``, ...)."""
    import threading

    from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

    ready, addr = threading.Event(), [None]

    def publish(a):
        addr[0] = a
        ready.set()

    def rank(r):
        kw = dict((kwargs_by_rank or {}).get(r, {}), timeout=timeout)
        if r == 0:
            proc = TcpProc(0, n, coordinator=("127.0.0.1", 0), on_coordinator_bound=publish,
                           **kw)
        else:
            if not ready.wait(timeout):
                raise SystemExit("host plane: no coordinator address")
            proc = TcpProc(r, n, coordinator=addr[0], **kw)
        try:
            return prog(proc)
        finally:
            proc.close()

    return _in_threads(n, rank, timeout)


def _host_moe_inputs(np, n, tokens):
    """The host-plane MoE's experts and tokens at the headline width, from
    HOST_MOE_SEED (numpy; every rank takes its expert and its tokens)."""
    D, F = HEADLINE["d_model"], HEADLINE["d_ff"]
    rng = np.random.default_rng(HOST_MOE_SEED)
    full = {"router": rng.standard_normal((D, n), dtype=np.float32) * D ** -0.5,
            "w_in": rng.standard_normal((n, D, F), dtype=np.float32) * D ** -0.5,
            "w_out": rng.standard_normal((n, F, D), dtype=np.float32) * F ** -0.5}
    return full, rng.standard_normal((n * tokens, D), dtype=np.float32)


def _host_moe_check(torch, moe, full, x_all, ys, keeps, n, tokens) -> dict:
    """Every rank's ``y`` and ``keep`` (gathered) against
    ``moe_reference_dense`` over all tokens on the card, and the reference's
    kept mask (first come, first served per (block, expert))."""
    cap = max(1, int(HOST_MOE_CAPACITY * tokens / n))
    full_t = moe.moe_params_from_numpy(full, device="cuda")
    xa = torch.from_numpy(x_all).to("cuda")
    dense = moe.moe_reference_dense(full_t, xa, n, cap, block_tokens=tokens)
    expert = torch.argmax(torch.softmax(xa @ full_t["router"], dim=-1), dim=-1)
    blocks = torch.nn.functional.one_hot(expert, n).reshape(n, tokens, n)
    keep_ref = (((torch.cumsum(blocks, dim=1) - 1) * blocks).sum(-1) < cap).reshape(-1)
    y_all = torch.cat([torch.as_tensor(v) for v in ys]).to("cuda")
    keep_all = torch.cat([torch.as_tensor(v) for v in keeps]).to("cuda")
    return {"rel_err": float((y_all - dense).abs().max() / dense.abs().max()),
            "keep_equal": bool(torch.equal(keep_all, keep_ref)),
            "kept_total": int(keep_all.sum()), "finite": bool(torch.isfinite(y_all).all()),
            "cap": cap}


def _moe_ok(res) -> bool:
    return res["rel_err"] <= MOE_REL_TOL and res["keep_equal"] and res["finite"]


def _host_plane_prog(torch, np, zmpi, torch_sum, moe_case=None):
    """The per-rank body of check_host_plane: rank 0's µs per call (a
    barrier before each call), and exact checks against numpy.  With
    ``moe_case`` (experts, tokens), one ``moe_host_ffn`` call at the
    host-moe width, experts on the card, held by rank 0 against the
    dense reference."""
    def timed(ep, fn, reps):
        times, out = [], None
        for _ in range(reps):
            ep.barrier()
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e6)
        times.sort()
        return out, times[len(times) // 2]

    def prog(ep):
        r, n = ep.rank, ep.size
        us = {}
        _, us["barrier"] = timed(ep, ep.barrier, HOST_REPS)
        for label, (nbytes, reps) in HOST_SIZES.items():
            count = nbytes // 8
            x = torch.from_numpy(np.arange(count, dtype=np.int64) * (r + 1) + r)
            got, us[f"allreduce_{label}"] = timed(ep, lambda: ep.allreduce(x, torch_sum), reps)
            want = np.arange(count, dtype=np.int64) * (n * (n + 1) // 2) + n * (n - 1) // 2
            if not (isinstance(got, torch.Tensor) and got.dtype == torch.int64
                    and np.array_equal(got.numpy(), want)):
                raise SystemExit(f"host plane: allreduce {label} is wrong on rank {r}")
        blocks = [torch.full((128,), 1000 * r + d, dtype=torch.int64) for d in range(n)]
        got, us["alltoall_1KiB"] = timed(ep, lambda: ep.alltoall(blocks), HOST_REPS)
        if [int(b[0]) for b in got] != [1000 * s + r for s in range(n)]:
            raise SystemExit(f"host plane: alltoall is wrong on rank {r}")
        small = torch.full((128,), r + 1, dtype=torch.int64)
        got, us["iallreduce_1KiB"] = timed(
            ep, lambda: ep.iallreduce(small, torch_sum).wait(HOST_TIMEOUT_S), HOST_REPS)
        if not bool((got == n * (n + 1) // 2).all()):
            raise SystemExit(f"host plane: iallreduce is wrong on rank {r}")
        got, us["bcast_1KiB"] = timed(
            ep, lambda: ep.bcast(small if r == n - 1 else None, root=n - 1), HOST_REPS)
        if not bool((got == n).all()):
            raise SystemExit(f"host plane: bcast is wrong on rank {r}")
        big = torch.arange(HOST_P2P_BYTES // 4, dtype=torch.float32)

        def p2p():
            if r == 0:
                ep.send(big, 1, tag=77)
            elif r == 1:
                got = ep.recv(0, tag=77, timeout=HOST_TIMEOUT_S)
                if not torch.equal(got, big):
                    raise SystemExit("host plane: the 4 MiB message is wrong")

        _, us["p2p_4MiB"] = timed(ep, p2p, HOST_P2P_REPS)
        refused = None
        if hasattr(ep, "address_book") and r == 0:
            refused = []
            cuda = torch.ones(4, device="cuda")
            for call in (lambda: ep.send(cuda, 1, tag=78), lambda: ep.isend(cuda, 1, tag=78)):
                try:
                    call()
                    refused.append(None)
                except zmpi.errors.TypeError_ as e:
                    refused.append(str(e))
        moe_res = None
        if moe_case is not None:
            from zhpe_ompi_tpu_torch.models import moe

            full, x_all = moe_case
            tokens = HOST_MOE_TOKENS
            params = moe.moe_params_from_numpy(full, device="cuda", ep_rank=r)
            x = torch.from_numpy(x_all[r * tokens:(r + 1) * tokens]).to("cuda")
            ep.barrier()
            t0 = time.perf_counter()
            y, keep = moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            ys, keeps = ep.gather(y.cpu(), root=0), ep.gather(keep.cpu(), root=0)
            if r == 0:
                moe_res = dict(_host_moe_check(torch, moe, full, x_all, ys, keeps, n,
                                               tokens), ms=ms)
        ep.barrier()
        return us, refused, moe_res

    return prog


# Phase 15's planes: the thread universe, then 4-rank TcpProc universes in
# this process's threads — per rank constructor overrides.  "tcp": sm off
# (every frame on the loopback wire); "sm": sm at its default (one boot
# id, the rings carry the data); "han": sm_boot_id pinned so ranks 0-1 and
# 2-3 are two emulated hosts (coll_han_enable auto engages); "numa": one
# boot id, sm_numa_id pinned to two domains of two ranks (three-level han).
HOST_TCP_PLANES = {
    "tcp": {r: {"sm": False} for r in range(HOST_RANKS)},
    "sm": {},
    "han": {r: {"sm_boot_id": "smoke-host-a" if r < 2 else "smoke-host-b"}
            for r in range(HOST_RANKS)},
    "numa": {r: {"sm_numa_id": "d0" if r < 2 else "d1"} for r in range(HOST_RANKS)},
}
HOST_COUNTERS = ("sm_bytes_sent", "tcp_bytes_sent", "sm_fallback_tcp_sends",
                 "coll_han_intra_bytes", "coll_han_inter_bytes", "han_flat_fallbacks",
                 "coll_han_numa_collectives", "coll_han_alltoall_collectives")


def check_host_plane(torch, np, card_line):
    """Phase 15: the host plane's collectives and messages on the thread
    universe and the four TcpProc planes of HOST_TCP_PLANES, exact against
    numpy, with rank 0's median µs per call and each plane's counters; a
    CUDA tensor sent by a TcpProc must raise dss's typed error; the han
    plane also runs moe_host_ffn against the dense reference; no ring file,
    poll thread, audit failure or han tag window may outlive a plane."""
    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import han
    from zhpe_ompi_tpu_torch.coll import host as coll_host
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.pt2pt import groups, sm
    from zhpe_ompi_tpu_torch.pt2pt import tcp  # noqa: F401 - registers tcp_*
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse
    from zhpe_ompi_tpu_torch.runtime import spc

    moe_case = _host_moe_inputs(np, HOST_RANKS, HOST_MOE_TOKENS)
    calls = {"ring": 0, "numa_allreduce": 0, "numa_bcast": 0, "numa_barrier": 0}
    patched = [(coll_host, "_allreduce_ring", "ring"),
               (han, "_allreduce_numa", "numa_allreduce"),
               (han, "_bcast_numa", "numa_bcast"),
               (han, "_barrier_numa", "numa_barrier")]
    saved = []
    for mod, name, key in patched:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def counted(*a, _fn=fn, _key=key):
            calls[_key] += 1
            return _fn(*a)

        setattr(mod, name, counted)
    res = {"large_msg": mca_var.get("host_coll_large_msg"),
           "tcp_eager_limit": mca_var.get("tcp_eager_limit"),
           "sm_ring_bytes": mca_var.get("sm_ring_bytes"),
           "sm_max_frag": mca_var.get("sm_max_frag")}
    try:
        for plane in ("thread", *HOST_TCP_PLANES):
            prog = _host_plane_prog(torch, np, zmpi, zmpi.SUM,
                                    moe_case if plane == "han" else None)
            for k in calls:
                calls[k] = 0
            before = {k: spc.read(k) for k in HOST_COUNTERS}
            t0 = time.perf_counter()
            if plane == "thread":
                uni = LocalUniverse(HOST_RANKS)
                try:
                    out = uni.run(prog, timeout=HOST_TIMEOUT_S)
                finally:
                    uni.close()
            else:
                out = _tcp_run(HOST_RANKS, prog, HOST_TIMEOUT_S, HOST_TCP_PLANES[plane])
            res[plane] = {"us_per_call": out[0][0], "s": time.perf_counter() - t0,
                          "ring_calls": calls["ring"],
                          "numa_calls": {k: v for k, v in calls.items() if k != "ring"},
                          "counters": {k: spc.read(k) - before[k] for k in HOST_COUNTERS},
                          "cuda_send_refused": out[0][1], "moe": out[0][2],
                          "leftovers": [*sm.orphaned_ring_files(), *sm.live_poll_threads(),
                                        *sm.segment_audit_failures(),
                                        *groups.leaked_tag_windows()]}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(json.dumps({"host_plane": res, "card": card_line}))
    # the two sizes above host_coll_large_msg take the ring on every rank,
    # once per timed call, wherever the allreduce is flat
    want_ring = HOST_RANKS * sum(reps for nbytes, reps in HOST_SIZES.values()
                                 if nbytes >= res["large_msg"])
    for plane in ("thread", "tcp", "sm"):
        if res[plane]["ring_calls"] != want_ring:
            raise SystemExit(f"host plane ({plane}): {res[plane]['ring_calls']} ring "
                             f"allreduces, expected {want_ring}")
    for plane in HOST_TCP_PLANES:
        got = res[plane]
        refused = got["cuda_send_refused"]
        if not (refused and all(m is not None and ".cpu()" in m for m in refused)):
            raise SystemExit(f"host plane ({plane}): TcpProc sent a CUDA tensor: {refused}")
        if got["leftovers"]:
            raise SystemExit(f"host plane ({plane}): left behind {got['leftovers']}")
    c = {plane: res[plane]["counters"] for plane in HOST_TCP_PLANES}
    if c["tcp"]["sm_bytes_sent"] != 0:
        raise SystemExit(f"host plane (tcp): ring bytes with sm off: {c['tcp']}")
    # sm: the rings carry the data; the wire only the modex frames
    if not (c["sm"]["sm_bytes_sent"] > HOST_RANKS * (64 << 20)
            and c["sm"]["tcp_bytes_sent"] < 16 << 10 and c["sm"]["sm_fallback_tcp_sends"] == 0):
        raise SystemExit(f"host plane (sm): the rings did not carry the data: {c['sm']}")
    if not (c["han"]["coll_han_intra_bytes"] > 0 and c["han"]["coll_han_inter_bytes"] > 0
            and c["han"]["han_flat_fallbacks"] == 0):
        raise SystemExit(f"host plane (han): the two-level schedules did not run: {c['han']}")
    moe_res = res["han"]["moe"]
    if not (moe_res and _moe_ok(moe_res)
            and c["han"]["coll_han_alltoall_collectives"] >= 2 * HOST_RANKS):
        raise SystemExit(f"host plane (han): moe_host_ffn is wrong or flat: {moe_res}")
    numa = res["numa"]["numa_calls"]
    if not (all(v > 0 for v in numa.values())
            and c["numa"]["coll_han_numa_collectives"] >= sum(numa.values())
            and c["numa"]["han_flat_fallbacks"] == 0):
        raise SystemExit(f"host plane (numa): the three-level schedules did not run: "
                         f"{numa} {c['numa']}")
    print(f"host plane: rank 0 µs per call by plane "
          f"{ {p: res[p]['us_per_call'] for p in ('thread', *HOST_TCP_PLANES)} }; "
          f"han moe_host_ffn {moe_res['ms']} ms, rel err {moe_res['rel_err']} on {card_line}")
    return res


def _host_rendezvous(srv, size):
    """The launcher-hosted coordinator of ZMPI_COORD_EXTERNAL: gather every
    rank's modex card, hand back the address book."""
    from zhpe_ompi_tpu_torch.pt2pt import tcp
    from zhpe_ompi_tpu_torch.utils import dss

    book, conns = [None] * size, []
    for _ in range(size):
        conn, _ = srv.accept()
        rank, card = dss.unpack(tcp._recv_frame(conn))
        book[rank] = card
        conns.append(conn)
    for conn in conns:
        tcp._send_frame(conn, dss.pack(book))
        conn.close()


def host_moe_child() -> int:
    """Phase 16's child: one rank of the host-plane MoE job (see the module
    doc), through ``zmpi.host_init``; prints one JSON line."""
    import numpy as np
    import torch

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.models import moe
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm
    from zhpe_ompi_tpu_torch.runtime import spc

    torch.backends.cuda.matmul.allow_tf32 = False
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r, n, T = ep.rank, ep.size, HOST_MOE_TOKENS
    full, x_all = _host_moe_inputs(np, n, T)
    params = moe.moe_params_from_numpy(full, device="cuda", ep_rank=r)
    x = torch.from_numpy(x_all[r * T:(r + 1) * T]).to("cuda")
    counted = _kernel_counters(fused_norm, fa)
    moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)  # warm-up
    for fn in counted.values():
        fn.launches = 0
    wire0, ring0 = spc.read("tcp_bytes_sent"), spc.read("sm_bytes_sent")
    times = []
    for _ in range(HOST_MOE_CALLS):
        ep.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, keep = moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    # the barriers' frames are counted too: a few hundred bytes a call
    wire = (spc.read("tcp_bytes_sent") - wire0) / HOST_MOE_CALLS
    ring = (spc.read("sm_bytes_sent") - ring0) / HOST_MOE_CALLS
    split: dict = {}
    for _ in range(HOST_MOE_CALLS):
        ep.barrier()
        moe.moe_host_ffn(ep, params, x, HOST_MOE_CAPACITY, timings=split)
    launches = {name: fn.launches for name, fn in counted.items()}
    times.sort()
    out = {"rank": r, "size": n, "sm": ep._sm_seg is not None,
           "median_ms": times[len(times) // 2], "ms": times,
           "split_ms": {k: v * 1e3 / HOST_MOE_CALLS for k, v in split.items()},
           "launches": launches, "wire_bytes_sent_per_call": wire,
           "ring_bytes_sent_per_call": ring, "kept": int(keep.sum())}
    ys = ep.gather(y.cpu(), root=0)
    keeps = ep.gather(keep.cpu(), root=0)
    if r == 0:
        out.update(_host_moe_check(torch, moe, full, x_all, ys, keeps, n, T))
    zmpi.host_finalize()
    print(json.dumps(out))
    if r == 0 and not _moe_ok(out):
        return 1
    if any(launches.values()):
        return 1
    return 0


def drive_host_moe(torch, card_line, sm=None):
    """One phase-16 job: start HOST_MOE_RANKS children of this script with
    the ZMPI_* contract (this process hosts the rendezvous) and collect
    their results; any child that fails or prints nothing fails the smoke.
    ``sm`` None leaves ``ZMPI_MCA_sm`` unset (the default: the rings carry
    the alltoalls), else exports it."""
    import socket

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(HOST_MOE_RANKS)
    srv.settimeout(HOST_TIMEOUT_S)
    host, port = srv.getsockname()
    env = dict(os.environ, ZMPI_SIZE=str(HOST_MOE_RANKS), ZMPI_COORD_HOST=host,
               ZMPI_COORD_PORT=str(port), ZMPI_COORD_EXTERNAL="1")
    for k in ("ZMPI_PMIX", "ZMPI_FT", "ZMPI_MCA_sm"):
        env.pop(k, None)
    if sm is not None:
        env["ZMPI_MCA_sm"] = str(sm)
    label = "sm unset" if sm is None else f"ZMPI_MCA_sm={sm}"
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--host-moe-child"],
        env=dict(env, ZMPI_RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(HOST_MOE_RANKS)]
    try:
        _host_rendezvous(srv, HOST_MOE_RANKS)
        outs = [c.communicate(timeout=HOST_TIMEOUT_S) for c in children]
    finally:
        srv.close()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    results = []
    for r, (c, (out, err)) in enumerate(zip(children, outs)):
        lines = out.strip().splitlines()
        if c.returncode != 0 or not lines:
            raise SystemExit(f"host moe ({label}): rank {r} exited {c.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
        results.append(json.loads(lines[-1]))
    want_sm = sm is None or int(sm) != 0
    if any(x["sm"] != want_sm for x in results):
        raise SystemExit(f"host moe ({label}): a rank's sm segment is not as configured")
    if want_sm and any(x["ring_bytes_sent_per_call"] <= 0 for x in results):
        raise SystemExit(f"host moe ({label}): the rings did not carry the alltoalls")
    res = {"config": label, "ranks": results, "s": time.perf_counter() - t0,
           "median_ms": max(x["median_ms"] for x in results)}
    print(json.dumps({"host_moe": res, "card": card_line}))
    head = results[0]
    print(f"host moe ({label}): moe_host_ffn median {res['median_ms']} ms (slowest rank), "
          f"rank 0 split {head['split_ms']} ms, ring {head['ring_bytes_sent_per_call']} B "
          f"and wire {head['wire_bytes_sent_per_call']} B per call, rel err "
          f"{head['rel_err']} (tol {MOE_REL_TOL}), kept {head['kept_total']} of "
          f"{HOST_MOE_RANKS * HOST_MOE_TOKENS} on {card_line}")
    return res


def drive_host_moe_both(torch, card_line) -> dict:
    """Phase 16 in both configurations, one after the other (each in
    processes of its own): sm at its default, then sm off."""
    return {"sm_default": drive_host_moe(torch, card_line),
            "sm_off": drive_host_moe(torch, card_line, sm=0)}


def _ft_legs(spans, t_class, t_fault):
    """Recovery legs of one fault from the run's ztrace spans, in ms from
    its classification: detect (the fault to its classification), then
    agree and shrink (the survivors' failed-set agreement and shrink),
    rollback, respawn, and rejoin (the full-size re-shrink the replacement
    joins), each the latest end among the ranks of their first such span
    after the classification (the survivors' only for agree, shrink and
    rollback: a replacement's are its own)."""
    after = [s for s in spans if s["t0"] >= t_class]

    def latest_first(pred):
        first: dict = {}
        for s in after:
            if pred(s):
                first.setdefault(s["rank"], s["t1"])
        return (max(first.values()) - t_class) / 1e6 if first else None

    respawn = [s for s in after if s["kind"] == "respawn"]
    t_respawn = respawn[0]["t0"] if respawn else None
    rollbacks = [s["t1"] for s in after if s["kind"] == "rollback"
                 and (t_respawn is None or s["t0"] < t_respawn)]
    return {
        "detect": (t_class - t_fault) / 1e6,
        "agree": latest_first(lambda s: s["kind"] == "agree"
                              and s["rank"] != FT_VICTIM),
        "shrink": latest_first(lambda s: s["kind"] == "shrink"
                               and s.get("survivors") == FT_RANKS - 1),
        "rollback": (max(rollbacks) - t_class) / 1e6 if rollbacks else None,
        "respawn": (respawn[0]["t1"] - t_class) / 1e6 if respawn else None,
        "rejoin": latest_first(lambda s: s["kind"] == "shrink"
                               and s.get("survivors") == FT_RANKS),
    }


def _ft_run(torch, np, tfm, cfg, init, batches, counted, fault, card_line,
            collective=False):
    """One FtTrainLoop run of FT_RANKS thread ranks of an ft LocalUniverse
    on the card (phase 17), under ``fault`` (None, "kill" or "wedge"), with
    a serial Checkpointer per rank or, ``collective``, one
    CollectiveCheckpointer per rank over a shared directory.  Returns what
    the checks and the report need."""
    import shutil

    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.ft import recovery, ulfm
    from zhpe_ompi_tpu_torch.ft.inject import FaultPlan
    from zhpe_ompi_tpu_torch.io import ckptio
    from zhpe_ompi_tpu_torch.models import ftloop
    from zhpe_ompi_tpu_torch.parallel import mesh
    from zhpe_ompi_tpu_torch.pt2pt.universe import LocalUniverse
    from zhpe_ompi_tpu_torch.runtime import checkpoint, flightrec, spc, ztrace

    names = {fn.__name__: name for name, fn in counted.items()}
    plan = FaultPlan(seed=FT_SEED)
    if fault == "kill":
        plan.kill_then_respawn(FT_VICTIM, after_ops=FT_KILL_AFTER_OPS)
    elif fault == "wedge":
        plan.wedge_device(FT_VICTIM, after_steps=FT_FAULT_STEP)
    stamps: dict = {}
    records: list = []
    timings: dict = {}
    ckpt_ms: list = []
    drain_ms: list = []
    commits: list = []
    handles: dict = {}
    root = tempfile.mkdtemp(prefix="zmpi-ft-")

    class TimedCheckpointer(checkpoint.Checkpointer):
        """The serial Checkpointer, its saves timed and its restores'
        steps kept (the rollback step)."""

        restored: list

        def save(self, step, state, blocking=False):
            t0 = time.perf_counter()
            super().save(step, state, blocking)
            ckpt_ms.append((time.perf_counter() - t0) * 1e3)

        def restore(self, step=None, placements=None):
            out = super().restore(step, placements)
            self.restored.append(int(out[1]))
            return out

    class TimedCollective(ckptio.CollectiveCheckpointer):
        """The collective checkpointer, its saves' return and its streams'
        drains timed, its restores' steps kept."""

        restored: list

        def save(self, step, state, blocking=False):
            t0 = time.perf_counter()
            super().save(step, state, blocking)
            ckpt_ms.append((time.perf_counter() - t0) * 1e3)

        def _drain(self, *args, **kw):
            t0 = time.perf_counter()
            try:
                super()._drain(*args, **kw)
            finally:
                drain_ms.append((time.perf_counter() - t0) * 1e3)

        def _commit(self, step, *args, **kw):
            super()._commit(step, *args, **kw)
            commits.append(step)

        def restore(self, step=None, shardings=None):
            out = super().restore(step, shardings)
            self.restored.append(int(out[1]))
            return out

    def make_loop(ctx, first_life):
        rank = ctx.rank
        wrap = None
        if fault == "kill" and first_life and rank == FT_VICTIM:
            def wrap(ep, i):
                if i != FT_FAULT_STEP:
                    return ep
                inj = plan.arm(ep)
                die = inj.die

                def stamped_die():
                    stamps.setdefault("fault", time.monotonic_ns())
                    die()

                inj.die = stamped_die
                return inj
        tokens, targets = batches[rank]
        step = ftloop.make_dp_step(
            cfg, tokens, targets, FT_LR, device=FT_DEVICE, wrap=wrap,
            timings=timings.setdefault((rank, first_life), {}))

        def counted_step(ep, params, i):
            before = _build.thread_launches()
            try:
                return step(ep, params, i)
            finally:
                after = _build.thread_launches()
                records.append((rank, first_life, i, {
                    names[k]: after.get(k, 0) - before.get(k, 0) for k in names}))

        wedge = plan.arm_device(rank, state=ctx.ft_state) if first_life else None
        if fault == "wedge" and wedge is not None and rank == FT_VICTIM:
            fire = wedge.fire

            def stamped_fire():
                stamps.setdefault("fault", time.monotonic_ns())
                fire()

            wedge.fire = stamped_fire
        # the default probe: the real killable CUDA child of probe_device_plane
        probe = mesh.DeviceLivenessProbe(
            state=ctx.ft_state, rank=rank, enable=True, deadline=FT_GUARD_S,
            probe_deadline=FT_PROBE_DEADLINE_S, timeout=FT_PROBE_TIMEOUT_S,
            device=FT_DEVICE)
        if collective:
            ck = TimedCollective(os.path.join(root, "shared"), keep=3,
                                 check_quiescent=False)
        else:
            ck = TimedCheckpointer(os.path.join(root, f"r{rank}"), keep=3,
                                   check_quiescent=False)
        ck.restored = []
        return ftloop.FtTrainLoop(
            ctx, step_fn=counted_step, state=dict(init), checkpointer=ck,
            ckpt_every=FT_CKPT_EVERY, probe=probe, wedge=wedge,
            respawner=respawner, shardings_fn=lambda ep: FT_DEVICE)

    def outcome(loop, tag):
        return (tag, {k: v.detach().cpu() for k, v in loop.state.items()},
                list(loop.losses), loop.recoveries, list(loop.ckpt.restored))

    def replacement(ctx):
        ctx.set_errhandler(errh.ERRORS_RETURN)
        loop = make_loop(ctx, first_life=False)
        loop.restore(FT_DEVICE)
        loop.run(FT_STEPS)
        return outcome(loop, "replacement")

    def respawner(victims):
        handles.update(recovery.respawn_ranks(uni, victims, replacement))

    def prog(ctx):
        ctx.set_errhandler(errh.ERRORS_RETURN)
        loop = make_loop(ctx, first_life=True)
        try:
            loop.run(FT_STEPS)
        except errors.DeviceFault as e:
            return ("wedged", ctx.rank in e.failed_ranks)
        return outcome(loop, "done")

    uni = LocalUniverse(FT_RANKS, ft=True)
    fps0 = ulfm.false_positive_count()
    spc0 = spc.snapshot()
    for fn in counted.values():
        fn.launches = 0
    flightrec.arm()
    ztrace.arm()
    torch.cuda.reset_peak_memory_stats()
    uni.start_failure_detector(period=FT_DETECTOR_PERIOD_S, timeout=FT_DETECTOR_S)
    t0 = time.perf_counter()
    try:
        res = uni.run(prog, timeout=FT_RUN_TIMEOUT_S)
        second = {v: h.result(timeout=FT_RUN_TIMEOUT_S) for v, h in handles.items()}
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        window, anchors = flightrec.window(), flightrec.anchors()
        spans = ztrace.window()
    finally:
        uni.stop_failure_detector()
        ztrace.disarm()
        ztrace.clear()
        flightrec.disarm()
        flightrec.clear()
        uni.close()
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: fn.launches for name, fn in counted.items()}
    failed = sorted(uni.ft_state.failed())
    moved = {k: v - spc0.get(k, 0) for k, v in spc.snapshot().items()
             if v != spc0.get(k, 0)}
    delta = {k: v for k, v in moved.items() if k.startswith("device_")}
    ckpt_delta = {k: v for k, v in moved.items() if k.startswith("ckpt_")}
    return {"res": res, "second": second, "records": records, "launches": launches,
            "timings": timings, "ckpt_ms": ckpt_ms, "drain_ms": drain_ms,
            "commits": commits, "ckpt_spc": ckpt_delta,
            "stamps": stamps,
            "window": window, "anchors": anchors, "spans": spans,
            "failed": failed, "spc": delta, "wall_s": wall_s,
            "fps": ulfm.false_positive_count() - fps0,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def drive_ft(torch, np, tfm, fused_norm, fa, card_line):
    """Phase 17: FtTrainLoop at the flagship width on FT_RANKS thread ranks
    of an ft LocalUniverse on the card: a fault-free run, a kill inside a
    gradient allreduce (respawned), a device wedge (classified by the
    victim's own CUDA probe child, respawned).  See the module doc."""
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.ft import recovery, ulfm
    from zhpe_ompi_tpu_torch.io import ckptio
    from zhpe_ompi_tpu_torch.parallel import mesh
    from zhpe_ompi_tpu_torch.runtime import flightrec
    from zhpe_ompi_tpu_torch.utils import deadline

    t_phase = time.perf_counter()
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    init = tfm.params_from_numpy(numpy_params(cfg, seed=0), cfg, device=FT_DEVICE)
    batches = []
    for r in range(FT_RANKS):
        rng = np.random.default_rng(FT_SEED + r)
        batches.append(tuple(
            torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                            device=FT_DEVICE)
            for _ in range(2)))
    counted = _kernel_counters(fused_norm, fa)
    want = _step_launches(cfg)
    rollback = (FT_FAULT_STEP // FT_CKPT_EVERY) * FT_CKPT_EVERY
    runs, report = {}, {}
    for fault, collective in ((None, False), ("kill", False), ("wedge", False),
                              (None, True), ("kill", True)):
        label = (fault or "fault_free") + ("_collective" if collective else "")
        run = runs[label] = _ft_run(torch, np, tfm, cfg, init, batches, counted,
                                    fault, card_line, collective)
        res, second = run["res"], run["second"]
        # every attempted rank step launched the five kernels 9/9/4/4/4: the
        # forward kernels on the rank's own thread (its own tally), the
        # backward kernels on autograd's device thread, which all ranks
        # share (their total over the run's rank steps)
        fwd = ("layernorm_fwd", "flash_attention_fwd")
        bad = [rec for rec in run["records"] if any(rec[3][k] != want[k] for k in fwd)]
        n_steps = len(run["records"])
        if bad or run["launches"] != {k: n_steps * v for k, v in want.items()}:
            raise SystemExit(f"ft {label}: rank steps launched {bad[:3]} "
                             f"(expected {want} each); totals {run['launches']} "
                             f"over {n_steps} rank steps")
        finals = []
        # the collective checkpointer's step-2 stream drains during step 3:
        # the kill may land before it commits, and then every rank restores
        # step 0 (the newest complete step), one step for all
        back = rollback
        if collective and fault is not None:
            rows = [res[r] if r not in second else second[r] for r in range(FT_RANKS)]
            if {tuple(row[4]) for row in rows if isinstance(row, tuple)
                    and len(row) > 4} == {(0,)}:
                back = 0
        for r in range(FT_RANKS):
            row = res[r] if r not in second else second[r]
            if not (isinstance(row, tuple) and row[0] in ("done", "replacement")):
                raise SystemExit(f"ft {label}: rank {r} ended {row!r}")
            finals.append(row[1])
            want_rec = 0 if (fault is None or row[0] == "replacement") else 1
            want_restored = [] if fault is None else [back]
            want_len = FT_STEPS - back if row[0] == "replacement" else FT_STEPS
            if (row[3], row[4], len(row[2])) != (want_rec, want_restored, want_len):
                raise SystemExit(f"ft {label}: rank {r} recoveries {row[3]}, restored "
                                 f"{row[4]}, {len(row[2])} losses")
            if not all(math.isfinite(x) for x in row[2]):
                raise SystemExit(f"ft {label}: rank {r} losses not finite: {row[2]}")
        if run["failed"] or run["fps"]:
            raise SystemExit(f"ft {label}: failed {run['failed']} at the end, "
                             f"{run['fps']} detector false positives")
        if fault is not None and sorted(second) != [FT_VICTIM]:
            raise SystemExit(f"ft {label}: respawned {sorted(second)}")
        if fault == "kill" and res[FT_VICTIM] is not None:
            raise SystemExit(f"ft kill: the victim ended {res[FT_VICTIM]!r}")
        if fault == "wedge" and res[FT_VICTIM] != ("wedged", True):
            raise SystemExit(f"ft wedge: the victim ended {res[FT_VICTIM]!r}")
        base = runs["fault_free"]["finals"] if fault is not None else finals[0]
        max_diff = 0.0
        for r in range(FT_RANKS):
            for k, v in finals[r].items():
                if not torch.equal(v, base[k]):
                    max_diff = max(max_diff, float((v - base[k]).abs().max()))
        run["finals"] = finals[0]
        dev_events = [e for e in run["window"] if e["type"] == flightrec.DEVICE_FAULT]
        class_ns = None
        for e in run["window"]:
            if e["type"] == flightrec.FT_CLASS and e.get("rank") == FT_VICTIM:
                class_ns = e["t_ns"]
                break
        probe_s = [(s["t1"] - s["t0"]) / 1e9 for s in run["spans"]
                   if s["kind"] == "device_probe"]
        tim = [t for (r, first), t in run["timings"].items()]
        local = [x for t in tim for x in t.get("local", [])]
        allred = [x for t in tim for x in t.get("allreduce", [])]
        rep = {"checkpointer": "collective" if collective else "serial",
               "wall_s": run["wall_s"], "max_abs_diff_vs_fault_free": max_diff,
               "step_local_ms_median": _median(local) * 1e3,
               "step_allreduce_ms_median": _median(allred) * 1e3,
               "checkpoint_ms_median": _median(run["ckpt_ms"]),
               "checkpoints": len(run["ckpt_ms"]),
               "probe_children_s": sorted(probe_s),
               "device_spc": run["spc"], "peak_bytes": run["peak_bytes"],
               "rank_steps": len(run["records"]), "launches": run["launches"],
               "losses_rank0": res[0][2] if isinstance(res[0], tuple) else None}
        if collective:
            sp = run["ckpt_spc"]
            rep.update({
                "commits": run["commits"],
                "bytes_written_per_commit": (sp.get("ckpt_bytes_written", 0)
                                             / max(len(run["commits"]), 1)),
                "save_return_ms": sorted(run["ckpt_ms"]),
                "drain_ms": sorted(run["drain_ms"]),
                "drain_ms_median": _median(run["drain_ms"]),
                "restored_step": back if fault else None,
                "bytes_written": sp.get("ckpt_bytes_written", 0),
                "shards_written": sp.get("ckpt_shards_written", 0),
                "gather_bytes": sp.get("ckpt_gather_bytes", 0),
                "ckpt_delta_skips": sp.get("ckpt_delta_skips", 0),
                "ckpt_async_overlapped": sp.get("ckpt_async_overlapped", 0)})
        if fault is not None:
            if class_ns is None or "fault" not in run["stamps"]:
                raise SystemExit(f"ft {label}: no classification of the victim recorded")
            rep["fault_to_classification_ms"] = (class_ns - run["stamps"]["fault"]) / 1e6
            rep["legs_ms"] = _ft_legs(run["spans"], class_ns, run["stamps"]["fault"])
            rep["mttr_legs"] = recovery.mttr_legs(run["window"], run["anchors"])
        if fault == "wedge":
            if (len(dev_events) != 1 or dev_events[0].get("rank") != FT_VICTIM
                    or run["spc"].get("device_faults") != 1):
                raise SystemExit(f"ft wedge: device classifications {dev_events}, "
                                 f"counters {run['spc']}")
        elif dev_events or run["spc"].get("device_faults"):
            raise SystemExit(f"ft {label}: a device fault was classified: {dev_events}")
        if max_diff:
            raise SystemExit(f"ft {label}: final parameters differ from the fault-free "
                             f"run's by up to {max_diff}")
        report[label] = rep
        print(json.dumps({f"ft_{label}": rep, "card": card_line}))
    # nothing left behind: detector, respawn and watchdog threads, probe
    # children (a disarmed guard's last probe finishes within its timeout)
    t_end = time.monotonic() + FT_PROBE_TIMEOUT_S + 5.0
    while (deadline.orphaned_probe_processes() or deadline.live_watchdog_threads()) \
            and time.monotonic() < t_end:
        time.sleep(0.2)
    while ckptio.live_writer_threads() and time.monotonic() < t_end:
        time.sleep(0.2)
    leftovers = [*ulfm.live_detectors(), *recovery.live_respawn_threads(),
                 *ckptio.live_writer_threads(), *ckptio.orphaned_shard_temps(),
                 *deadline.live_watchdog_threads(), *deadline.orphaned_probe_processes(),
                 *mesh.live_prober_threads()]
    if leftovers:
        raise SystemExit(f"ft: left behind {leftovers}")
    per_step = {k: v // len(runs["fault_free"]["records"])
                for k, v in runs["fault_free"]["launches"].items()}
    report["launches_per_rank_step"] = per_step
    report["phase_s"] = time.perf_counter() - t_phase
    ff = report["fault_free"]
    print(f"ft (4 thread ranks, flagship width): step local {ff['step_local_ms_median']} "
          f"ms + allreduce {ff['step_allreduce_ms_median']} ms (medians), checkpoint "
          f"{ff['checkpoint_ms_median']} ms; kill classified in "
          f"{report['kill']['fault_to_classification_ms']} ms, legs "
          f"{report['kill']['legs_ms']}; wedge classified in "
          f"{report['wedge']['fault_to_classification_ms']} ms, legs "
          f"{report['wedge']['legs_ms']}; probe children "
          f"{report['wedge']['probe_children_s']} s; collective checkpointer: save "
          f"returns in {report['fault_free_collective']['checkpoint_ms_median']} ms, "
          f"drains in {report['fault_free_collective']['drain_ms_median']} ms, "
          f"{report['fault_free_collective']['bytes_written_per_commit']} bytes written "
          f"per checkpoint ({report['fault_free_collective']['commits']} committed), "
          f"{report['fault_free_collective']['ckpt_async_overlapped']} steps overlapped, "
          f"kill restored step {report['kill_collective']['restored_step']}; "
          f"phase {report['phase_s']} s on {card_line}")
    return per_step, report


def ft_child() -> int:
    """Phase 18's child: one rank of the process-plane ft job through
    ``zmpi.host_init`` under ZMPI_FT=1 (see the module doc); prints one
    JSON line.  The victim kills itself (SIGKILL) where the plan kills it."""
    import signal

    import numpy as np
    import torch

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import host as coll_host
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.ft import recovery, ulfm
    from zhpe_ompi_tpu_torch.ft.inject import FaultPlan
    from zhpe_ompi_tpu_torch.pt2pt import sm

    p = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    p.set_errhandler(errh.ERRORS_RETURN)
    r = p.rank
    dev = torch.arange(FT_PROC_ELEMS, dtype=torch.int64, device="cuda") * (r + 1) - r
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = dev.cpu()  # the staging to the host plane
    stage_ms = (time.perf_counter() - t0) * 1e3
    p.barrier()
    inj = FaultPlan(seed=FT_SEED).kill_rank(FT_PROC_VICTIM,
                                            after_ops=FT_KILL_AFTER_OPS).arm(p)
    kind = "completed"
    t0 = time.perf_counter()
    try:
        inj.allreduce(x, zmpi.SUM)
    except ulfm.RankKilled:
        os.kill(os.getpid(), signal.SIGKILL)  # a real crash: nothing cleans up
    except errors.ProcFailed:
        kind = "failed"
        p.revoke(coll_host.COLL_CID)
    except errors.Revoked:
        kind = "revoked"
    if not p.ft_state.wait_failed(FT_PROC_VICTIM, timeout=60.0):
        return 1
    classify_ms = (time.perf_counter() - t0) * 1e3
    cause = p.ft_state.cause_of(FT_PROC_VICTIM)
    p.failure_ack()
    failed, gen = recovery.agree_failed_set(p)
    sh = p.shrink()
    total = sh.allreduce(x, zmpi.SUM)
    recover_ms = (time.perf_counter() - t0) * 1e3
    want = sum(np.arange(FT_PROC_ELEMS, dtype=np.int64) * (q + 1) - q
               for q in range(p.size) if q != FT_PROC_VICTIM)
    exact = bool(np.array_equal(total.numpy(), want))
    sm_on = p._sm_seg is not None
    zmpi.host_finalize()
    print(json.dumps({"rank": r, "kind": kind, "cause": cause, "stage_ms": stage_ms,
                      "classify_ms": classify_ms, "recover_ms": recover_ms,
                      "failed": sorted(failed.items()), "gen": gen,
                      "shrunk": [sh.rank, sh.size, list(sh.group.ranks)],
                      "exact": exact, "sm": sm_on,
                      "rings": sm.orphaned_ring_files(), "polls": sm.live_poll_threads(),
                      "detectors": len(ulfm.live_detectors())}))
    return 0 if exact else 1


def drive_ft_processes(torch, card_line) -> dict:
    """Phase 18: FT_PROC_RANKS children of this script under ZMPI_FT=1 with
    the sm var at its default, the smoke hosting the rendezvous; the victim
    is killed inside a ring allreduce over the rings, the survivors ack,
    agree on the failed set, shrink to 3 and reduce exactly.  The victim's
    ring files are the launcher's to sweep (ZMPI_SESSION); the survivors
    must leave none, and no poll, detector or probe."""
    import glob
    import socket

    from zhpe_ompi_tpu_torch.pt2pt import sm

    session = f"zmpift{os.getpid()}"
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(FT_PROC_RANKS)
    srv.settimeout(HOST_TIMEOUT_S)
    host, port = srv.getsockname()
    env = dict(os.environ, ZMPI_SIZE=str(FT_PROC_RANKS), ZMPI_COORD_HOST=host,
               ZMPI_COORD_PORT=str(port), ZMPI_COORD_EXTERNAL="1", ZMPI_FT="1",
               ZMPI_SESSION=session)
    for k in ("ZMPI_PMIX", "ZMPI_MCA_sm"):
        env.pop(k, None)
    t0 = time.perf_counter()
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ft-child"],
        env=dict(env, ZMPI_RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(FT_PROC_RANKS)]
    try:
        _host_rendezvous(srv, FT_PROC_RANKS)
        outs = [c.communicate(timeout=HOST_TIMEOUT_S) for c in children]
    finally:
        srv.close()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    pattern = os.path.join(sm.segment_dir(), f"zompi_pyring_{session}_*")
    swept = sorted(glob.glob(pattern))
    for path in swept:  # the launcher's sweep of the killed rank's files
        os.unlink(path)
    if children[FT_PROC_VICTIM].returncode != -9:
        raise SystemExit(f"ft processes: the victim exited "
                         f"{children[FT_PROC_VICTIM].returncode}")
    results = []
    for r, (c, (out, err)) in enumerate(zip(children, outs)):
        if r == FT_PROC_VICTIM:
            continue
        lines = out.strip().splitlines()
        if c.returncode != 0 or not lines:
            raise SystemExit(f"ft processes: rank {r} exited {c.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
        results.append(json.loads(lines[-1]))
    survivors = [r for r in range(FT_PROC_RANKS) if r != FT_PROC_VICTIM]
    for k, x in enumerate(results):
        if not (x["exact"] and x["sm"] and x["shrunk"] == [k, 3, survivors]
                and [f[0] for f in x["failed"]] == [FT_PROC_VICTIM]
                and not x["rings"] and not x["polls"] and not x["detectors"]):
            raise SystemExit(f"ft processes: rank {survivors[k]} ended {x}")
    if len({(tuple(map(tuple, x["failed"])), x["gen"]) for x in results}) != 1:
        raise SystemExit("ft processes: the survivors' agreed failed sets differ")
    if not all(f"_{FT_PROC_VICTIM}_" in os.path.basename(p) for p in swept):
        raise SystemExit(f"ft processes: survivors' ring files were left: {swept}")
    if glob.glob(pattern):
        raise SystemExit("ft processes: ring files left after the sweep")
    res = {"ranks": results, "swept_victim_files": len(swept),
           "s": time.perf_counter() - t0}
    print(json.dumps({"ft_processes": res, "card": card_line}))
    print(f"ft processes (ZMPI_FT=1, sm default): victim rank {FT_PROC_VICTIM} "
          f"classified in {[x['classify_ms'] for x in results]} ms "
          f"({[x['cause'] for x in results]}), recovered and reduced exactly at 3 "
          f"ranks in {[x['recover_ms'] for x in results]} ms on {card_line}")
    return res


def _hybrid_batches(torch, np, cfg):
    """Every slice's (tokens, targets), each from its own seed."""
    out = []
    for r in range(HYBRID_RANKS):
        rng = np.random.default_rng(HYBRID_SEED + r)
        out.append(tuple(torch.as_tensor(rng.integers(0, cfg.vocab, (BATCH, cfg.seq)),
                                         device=HYBRID_DEVICE) for _ in range(2)))
    return out


def _params_digest(torch, params) -> str:
    """blake2b of every parameter's bytes (sorted names): equal digests on
    every slice are parameters equal in their bits."""
    import hashlib

    flat = torch.cat([params[k].detach().reshape(-1).view(torch.uint8)
                      for k in sorted(params)])
    return hashlib.blake2b(flat.cpu().numpy(), digest_size=16).hexdigest()


def _rel_update(a, b, p0) -> float:
    """|(a - p0) - (b - p0)| / |b - p0| (relative Frobenius norm)."""
    return float((a - b).norm() / (b - p0).norm())


def _state_bytes(torch, opt) -> int:
    return sum(v.numel() * v.element_size() for st in opt.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))


def hybrid_child() -> int:
    """Phase 19's child: one slice of the multi-slice job through
    ``zmpi.host_init`` (see the module doc); prints one JSON line."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm
    from zhpe_ompi_tpu_torch.parallel.zero import ZeroOptimizer
    from zhpe_ompi_tpu_torch.runtime import spc

    sync = torch.cuda.synchronize if HYBRID_DEVICE == "cuda" else (lambda: None)
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r = ep.rank
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    np_params = numpy_params(cfg, seed=0)
    batches = _hybrid_batches(torch, np, cfg)
    tokens, targets = batches[r]
    counted = _kernel_counters(fused_norm, fa)
    want = _step_launches(cfg)
    store = tempfile.mkdtemp(prefix="zmpi-hybrid-")
    dist.init_process_group(HYBRID_BACKEND,
                            store=dist.FileStore(os.path.join(store, "s"), 1),
                            rank=0, world_size=1)
    sent0 = spc.read("sm_bytes_sent")
    out: dict = {"rank": r, "size": ep.size}
    try:
        dp_comm = zmpi.Communicator(name="dp")

        def counted_step(run, one_step):
            """One step between launch counts set to 0 and read, the slices
            lined up by a barrier first; its ms, launches, host-plane bytes
            sent and the parameters' digest."""
            ep.barrier()
            for fn in counted.values():
                fn.launches = 0
            wire0 = spc.read("sm_bytes_sent") + spc.read("tcp_bytes_sent")
            sync()
            t0 = time.perf_counter()
            params = one_step()
            sync()
            run["ms"].append((time.perf_counter() - t0) * 1e3)
            run["launches"].append({k: fn.launches for k, fn in counted.items()})
            run["dcn_bytes_sent"].append(
                spc.read("sm_bytes_sent") + spc.read("tcp_bytes_sent") - wire0)
            run["digests"].append(_params_digest(torch, params))
            return params

        # the dcn path: make_train_step_optax(dcn_proc=ep), Adam
        params = tfm.params_from_numpy(np_params, cfg, device=HYBRID_DEVICE)
        params0 = {k: v.clone() for k, v in params.items()}
        timings: dict = {}
        init, step, _ = tfm.make_train_step_optax(cfg, dp_comm, dcn_proc=ep,
                                                  timings=timings)
        opt = init(params)
        hyb = out["hybrid"] = {"ms": [], "launches": [], "dcn_bytes_sent": [],
                               "digests": [], "split_ms": [], "losses": []}
        first = None
        torch.cuda.reset_peak_memory_stats()
        for i in range(HYBRID_STEPS):
            before = dict(timings)

            def one_step():
                nonlocal params, opt
                params, opt, loss = step(params, opt, tokens, targets)
                hyb["losses"].append(float(loss))
                return params

            counted_step(hyb, one_step)
            hyb["split_ms"].append({k: (v - before.get(k, 0.0)) * 1e3
                                    for k, v in timings.items()})
            if i == 0 and r == 0:
                first = ({k: v.clone() for k, v in params.items()},
                         {k: opt.state[params[k]]["exp_avg"].clone() for k in params})
        hyb["peak_bytes"] = torch.cuda.max_memory_allocated()
        replicated_bytes = _state_bytes(torch, opt)
        hybrid_final = {k: v.detach().clone() for k, v in params.items()}
        del opt, params
        if r == 0:
            # one process's Adam step over the slices' concatenated batch
            full_tok = torch.cat([b[0] for b in batches])
            full_tgt = torch.cat([b[1] for b in batches])
            ref = {k: v.clone() for k, v in params0.items()}
            leaves = {k: v.detach().requires_grad_(True) for k, v in ref.items()}
            loss = tfm.loss_fn(leaves, full_tok, full_tgt, cfg)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            ropt = tfm._adam(list(ref.values()))
            for k, g in zip(ref, grads):
                ref[k].grad = g
            with torch.no_grad():
                ropt.step()
            fp, fm = first
            out["full_batch"] = {
                "loss": float(loss), "hybrid_loss": hyb["losses"][0],
                "moment_rel": {k: _rel_update(fm[k], ropt.state[ref[k]]["exp_avg"],
                                              0.0) for k in ref},
                "update_rel": {k: _rel_update(fp[k], ref[k], params0[k]) for k in ref},
                "update_sign_flip_share": {
                    k: float(((fp[k] - params0[k]).sign()
                              != (ref[k] - params0[k]).sign()).float().mean())
                    for k in ref}}
            del ref, leaves, grads, ropt, first, fp, fm
        ep.barrier()

        # ZeroOptimizer from the same start on the same batches
        params = tfm.params_from_numpy(np_params, cfg, device=HYBRID_DEVICE)
        zopt = ZeroOptimizer(ep, None, params, device=HYBRID_DEVICE)
        zt: dict = {}
        zr = out["zero"] = {"ms": [], "launches": [], "dcn_bytes_sent": [],
                            "digests": [], "split_ms": [], "losses": []}
        torch.cuda.reset_peak_memory_stats()
        for i in range(HYBRID_STEPS):
            before = dict(zt)

            def one_step():
                nonlocal params
                sync()
                t0 = time.perf_counter()
                leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss = tfm.loss_fn(leaves, tokens, targets, cfg)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                sync()
                zt["local"] = zt.get("local", 0.0) + time.perf_counter() - t0
                zr["losses"].append(float(loss))
                params = zopt.step(params, dict(zip(leaves, grads)), timings=zt)
                return params

            counted_step(zr, one_step)
            zr["split_ms"].append({k: (v - before.get(k, 0.0)) * 1e3
                                   for k, v in zt.items()})
        zr["peak_bytes"] = torch.cuda.max_memory_allocated()
        chunk = -(-zopt._sizes["float32"] // ep.size)
        pad = (chunk * ep.size - zopt._sizes["float32"]) * 4 * 2
        out["state_bytes"] = {"zero": zopt.state_bytes(), "replicated": replicated_bytes,
                              "pad": pad}
        out["zero_vs_hybrid_rel"] = {k: _rel_update(params[k], hybrid_final[k],
                                                    params0[k]) for k in params}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out["ring_bytes_sent"] = spc.read("sm_bytes_sent") - sent0
    out["sm"] = ep._sm_seg is not None
    zmpi.host_finalize()
    print(json.dumps(out))
    return 0


def drive_hybrid(torch, card_line) -> dict:
    """Phase 19: HYBRID_RANKS children of this script, one slice each,
    through ``zmpi.host_init`` with the sm var at its default (this process
    hosts the rendezvous): the dcn path, then ZeroOptimizer, at the flagship
    width (see the module doc).  Fails unless every gate holds."""
    import socket

    t_phase = time.perf_counter()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(HYBRID_RANKS)
    srv.settimeout(HOST_TIMEOUT_S)
    host, port = srv.getsockname()
    env = dict(os.environ, ZMPI_SIZE=str(HYBRID_RANKS), ZMPI_COORD_HOST=host,
               ZMPI_COORD_PORT=str(port), ZMPI_COORD_EXTERNAL="1")
    for k in ("ZMPI_PMIX", "ZMPI_FT", "ZMPI_MCA_sm"):
        env.pop(k, None)
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--hybrid-child"],
        env=dict(env, ZMPI_RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(HYBRID_RANKS)]
    try:
        _host_rendezvous(srv, HYBRID_RANKS)
        outs = [c.communicate(timeout=HOST_TIMEOUT_S) for c in children]
    finally:
        srv.close()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    res = []
    for r, (c, (out, err)) in enumerate(zip(children, outs)):
        lines = out.strip().splitlines()
        if c.returncode != 0 or not lines:
            raise SystemExit(f"hybrid: rank {r} exited {c.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
        res.append(json.loads(lines[-1]))
    from zhpe_ompi_tpu_torch.models import transformer as tfm

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    want = _step_launches(cfg) if HYBRID_DEVICE == "cuda" else \
        {k: 0 for k in _step_launches(cfg)}
    for label in ("hybrid", "zero"):
        for x in res:
            if any(n != want for n in x[label]["launches"]):
                raise SystemExit(f"hybrid {label}: rank {x['rank']} launched "
                                 f"{x[label]['launches']} (expected {want} a step)")
        for i in range(HYBRID_STEPS):
            if len({x[label]["digests"][i] for x in res}) != 1:
                raise SystemExit(f"hybrid {label}: the slices' parameters differ "
                                 f"after step {i}")
        if not all(math.isfinite(v) for x in res for v in x[label]["losses"]):
            raise SystemExit(f"hybrid {label}: a loss is not finite")
    fb = res[0]["full_batch"]
    worst = max(fb["moment_rel"].values())
    if worst > UPDATE_REL_TOL or abs(fb["loss"] - fb["hybrid_loss"]) > TRAIN_LOSS_TOL:
        raise SystemExit(f"hybrid: the first step is not the full batch's: {fb}")
    zrel = max(v for x in res for v in x["zero_vs_hybrid_rel"].values())
    if zrel > HYBRID_ZERO_REL_TOL:
        raise SystemExit(f"hybrid: ZeroOptimizer's updates differ from the dcn path's "
                         f"by {zrel} (bound {HYBRID_ZERO_REL_TOL})")
    for x in res:
        sb = x["state_bytes"]
        if sb["zero"] > sb["replicated"] / HYBRID_RANKS + sb["pad"]:
            raise SystemExit(f"hybrid: rank {x['rank']} ZeRO state {sb}")
        if not x["sm"]:
            raise SystemExit(f"hybrid: rank {x['rank']} built no sm segment")

    def med(label, key):
        return _median([x[label][key][i] for x in res for i in range(HYBRID_STEPS)])

    def split(label):
        keys = sorted({k for x in res for d in x[label]["split_ms"] for k in d})
        return {k: _median([d.get(k, 0.0) for x in res for d in x[label]["split_ms"]])
                for k in keys}

    report = {
        "ranks": HYBRID_RANKS, "steps": HYBRID_STEPS,
        "step_ms_median": {"hybrid": med("hybrid", "ms"), "zero": med("zero", "ms")},
        "split_ms_median": {"hybrid": split("hybrid"), "zero": split("zero")},
        "dcn_bytes_sent_per_rank_step": {
            "hybrid": med("hybrid", "dcn_bytes_sent"), "zero": med("zero", "dcn_bytes_sent")},
        "peak_bytes_per_rank": {"hybrid": max(x["hybrid"]["peak_bytes"] for x in res),
                                "zero": max(x["zero"]["peak_bytes"] for x in res)},
        "ring_bytes_sent_per_rank": [x["ring_bytes_sent"] for x in res],
        "state_bytes": res[0]["state_bytes"],
        "full_batch": fb, "first_moment_rel_max": worst,
        "zero_vs_hybrid_rel_max": zrel,
        "losses_rank0": {"hybrid": res[0]["hybrid"]["losses"],
                         "zero": res[0]["zero"]["losses"]},
        "launches_per_step": {"hybrid": res[0]["hybrid"]["launches"][0],
                              "zero": res[0]["zero"]["launches"][0]},
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"hybrid": report, "card": card_line}))
    print(f"hybrid ({HYBRID_RANKS} host_init slices, flagship width, Adam): step "
          f"{report['step_ms_median']['hybrid']} ms, split {report['split_ms_median']['hybrid']}; "
          f"ZeRO step {report['step_ms_median']['zero']} ms, split "
          f"{report['split_ms_median']['zero']}; host-plane bytes sent per rank and step "
          f"{report['dcn_bytes_sent_per_rank_step']}; first moment vs the full batch "
          f"{worst} (bound {UPDATE_REL_TOL}); ZeRO vs dcn {zrel} (bound "
          f"{HYBRID_ZERO_REL_TOL}); state bytes {report['state_bytes']}; peak "
          f"{report['peak_bytes_per_rank']}; phase {report['phase_s']} s on {card_line}")
    return report


# -- phase 18's DVM run and phase 20 (the serving loop) ----------------------


def _dvm_launch(n, argv, mca, **kw):
    """One job of this script's children in a port ``Dvm`` hosted by this
    process: returns (rc, stdout, stderr, the daemon's counter deltas, its
    stat after the job, the daemon's session tag).  The daemon stops only
    after the job ended (its ranks hold a lifeline to it)."""
    import io
    import threading

    from zhpe_ompi_tpu_torch.runtime import dvm as dvm_mod

    d = dvm_mod.Dvm()
    try:
        cli = dvm_mod.DvmClient(d.address)
        before = cli.stat()
        out, err, res = io.StringIO(), io.StringIO(), {}
        controller = kw.pop("controller", None)

        def run():
            try:
                res["rc"] = cli.launch(n, [os.path.abspath(__file__), *argv],
                                       mca=mca, ft=True, stdout=out, stderr=err,
                                       **kw)
            except Exception as e:  # noqa: BLE001 - reported below
                res["error"] = f"{type(e).__name__}: {e}"

        t = threading.Thread(target=run, daemon=True)
        t.start()
        ctl = None if controller is None else controller(d.address, out, err)
        t.join(kw.get("timeout", 600.0) + 60.0)
        if t.is_alive() or "error" in res:
            raise SystemExit(f"dvm job {argv}: {res.get('error', 'hung')}\n"
                             f"{out.getvalue()[-3000:]}\n{_rank_tails(err.getvalue())}")
        stat = cli.stat()
        deltas = {k: stat[k] - before.get(k, 0)
                  for k in ("dvm_jobs_launched", "dvm_fault_events", "dvm_respawns",
                            "dvm_resizes", "pmix_gets")}
        cli.stop()
        cli.close()
    finally:
        d.stop()
    if dvm_mod.live_dvms() or dvm_mod.orphaned_daemon_processes():
        raise SystemExit("dvm: a daemon outlived its job")
    return res["rc"], out.getvalue(), err.getvalue(), deltas, stat, d.session, ctl


def _rank_tails(err, lines=80) -> str:
    """The last ``lines`` stderr lines of each rank of a daemon-hosted job
    (the daemon prefixes each with ``[rank:err] ``), rank by rank."""
    by_rank: dict = {}
    for line in err.splitlines():
        head = line.split("] ", 1)[0]
        by_rank.setdefault(head, []).append(line)
    return "\n".join("\n".join(v[-lines:]) for _, v in sorted(by_rank.items()))


def _child_json(text, tag):
    """The ``tag {json}`` lines the job's ranks printed, in the order
    printed (each behind the daemon's ``[rank] `` prefix)."""
    return [json.loads(line.split(f"{tag} ", 1)[1])
            for line in text.splitlines() if f"] {tag} " in line]


def _no_ring_files(session):
    import glob

    from zhpe_ompi_tpu_torch.pt2pt import sm

    left = glob.glob(os.path.join(sm.segment_dir(), f"zompi_pyring_{session}_*"))
    if left:
        raise SystemExit(f"dvm: ring files left after the job: {left}")


def ft_dvm_child() -> int:
    """Phase 18's DVM run's child: one rank of a daemon-hosted ft job (the
    ``ZMPI_PMIX`` contract); rank FT_PROC_VICTIM dies inside the ring
    allreduce, the survivors shrink to 3 and reduce exactly, the lowest
    asks the daemon to relaunch it (``recovery.daemon_respawn``), and all
    four reduce exactly again.  Prints one ``FTDVM {json}`` line."""
    import signal

    import numpy as np
    import torch

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.coll import han
    from zhpe_ompi_tpu_torch.coll import host as coll_host
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.ft import recovery, ulfm
    from zhpe_ompi_tpu_torch.ft.inject import FaultPlan

    legs = {"imports_s": time.time() - _T0}
    t = time.time()
    torch.zeros(1, device=SERVE_DEVICE)
    legs["cuda_init_s"] = time.time() - t
    rejoin = os.environ.get("ZMPI_REJOIN") == "1"
    t = time.time()
    p = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    legs["host_init_s"] = time.time() - t
    p.set_errhandler(errh.ERRORS_RETURN)
    r = p.rank
    x = (torch.arange(FT_PROC_ELEMS, dtype=torch.int64, device=SERVE_DEVICE)
         * (r + 1) - r).cpu()
    full = sum(np.arange(FT_PROC_ELEMS, dtype=np.int64) * (q + 1) - q
               for q in range(p.size))
    out = {"rank": r, "rejoin": rejoin, "legs": legs}
    if rejoin:
        # pairs with the survivors' post-rejoin shrink: the full-size
        # window is a fresh one (the survivors revoked the old)
        four = p.shrink()
        out["exact4"] = bool(np.array_equal(four.allreduce(x, zmpi.SUM).numpy(),
                                            full))
        zmpi.host_finalize()
        print("FTDVM " + json.dumps(out), flush=True)
        return 0 if out["exact4"] else 1
    seen = {}
    p.ft_state.add_failure_listener(
        lambda rank, cause: seen.setdefault(rank, (time.time(), cause)))
    p.barrier()
    inj = FaultPlan(seed=FT_SEED).kill_rank(FT_PROC_VICTIM,
                                            after_ops=FT_KILL_AFTER_OPS).arm(p)
    t_op = time.time()
    try:
        inj.allreduce(x, zmpi.SUM)
    except ulfm.RankKilled:
        os.kill(os.getpid(), signal.SIGKILL)  # a real crash: nothing cleans up
    except errors.ProcFailed:
        # the collective's other survivors may still wait on this rank
        p.revoke(coll_host.COLL_CID)
    except errors.Revoked:
        pass
    deadline = time.monotonic() + 60.0
    while FT_PROC_VICTIM not in seen:  # the listener runs after the mark
        if time.monotonic() > deadline:
            return 1
        time.sleep(0.001)
    three = {}

    def on_three(sh):
        want = sum(np.arange(FT_PROC_ELEMS, dtype=np.int64) * (q + 1) - q
                   for q in range(p.size) if q != FT_PROC_VICTIM)
        three["exact3"] = bool(np.array_equal(sh.allreduce(x, zmpi.SUM).numpy(),
                                              want))
        three["shrunk"] = [sh.rank, sh.size]
        three["t"] = time.time()

    def respawner(victims):
        t0 = time.time()
        pids = recovery.daemon_respawn(victims)
        out["respawn_rpc_ms"] = (time.time() - t0) * 1e3
        return pids

    t_class, cause = seen[FT_PROC_VICTIM]
    _, victims = recovery.respawn_victims(p, respawner, rollback_fn=on_three,
                                          timeout=SERVE_REJOIN_S)
    ok = recovery.await_rejoin(p, FT_PROC_VICTIM, SERVE_REJOIN_S)
    t_join = time.time()
    out.update(three, victims=victims, rejoined=ok, cause=cause,
               classify_ms=(t_class - t_op) * 1e3,
               shrink_ms=(three["t"] - t_class) * 1e3,
               respawn_to_rejoin_ms=(t_join - three["t"]) * 1e3)
    # a fresh generation for the full-size window (FtInferLoop's recovery
    # tail): the epoch floor rises, the locality topology is re-derived
    p.ft_state.raise_epoch(p.ft_state.crash_epoch() + 1)
    han.invalidate(p)
    four = p.shrink()
    out["exact4"] = bool(np.array_equal(four.allreduce(x, zmpi.SUM).numpy(), full))
    zmpi.host_finalize()
    print("FTDVM " + json.dumps(out), flush=True)
    return 0 if out["exact4"] and three["exact3"] else 1


def drive_ft_dvm(torch, card_line) -> dict:
    """Phase 18's second run: FT_PROC_RANKS children of this script hosted
    by the port's ``Dvm`` in this process (``--ft-dvm-child``; the sm var
    at its default, the ``ZMPI_PMIX`` contract), the heartbeat window the
    namesake's DVM drills use (only the daemon's waitpid classifies in
    time).  Gates: the survivors reduce exactly at 3, the daemon relaunches
    the victim, it rejoins, and all four reduce exactly; one respawn (and
    at most one fault event) counted by the daemon; no namespace, ring
    file or daemon left."""
    t0 = time.perf_counter()
    rc, text, err, deltas, stat, session, _ = _dvm_launch(
        FT_PROC_RANKS, ["--ft-dvm-child"], SERVE_MCA, timeout=SERVE_JOB_S)
    rows = _child_json(text, "FTDVM")
    if rc != 0 or len(rows) != FT_PROC_RANKS:
        raise SystemExit(f"ft dvm: rc {rc}, {len(rows)} results\n{text[-3000:]}\n"
                         f"{_rank_tails(err)}")
    surv = [x for x in rows if not x["rejoin"]]
    repl = [x for x in rows if x["rejoin"]]
    if not (len(repl) == 1 and repl[0]["rank"] == FT_PROC_VICTIM
            and all(x["exact4"] for x in rows)
            and all(x["exact3"] and x["rejoined"] and x["victims"] == [FT_PROC_VICTIM]
                    for x in surv)):
        raise SystemExit(f"ft dvm: {rows}")
    # the daemon counts the fault event only when the corpse's exit beats
    # the respawn RPC: a SIGKILLed rank that held a CUDA context takes
    # 0.2-0.3 s to exit, and the transport classifies it sooner, so the
    # RPC may find the corpse still exiting, kill and reap it itself
    if deltas["dvm_fault_events"] not in (0, 1) or deltas["dvm_respawns"] != 1 \
            or stat["pmix"] != {}:
        raise SystemExit(f"ft dvm: daemon counters {deltas}, store {stat['pmix']}")
    _no_ring_files(session)
    lead = min(surv, key=lambda x: x["rank"])
    res = {"survivors": surv, "replacement": repl[0], "daemon": deltas,
           "s": time.perf_counter() - t0}
    print(json.dumps({"ft_dvm": res, "card": card_line}))
    print(f"ft processes under the port's Dvm: victim rank {FT_PROC_VICTIM} "
          f"classified in {[x['classify_ms'] for x in surv]} ms "
          f"({[x['cause'] for x in surv]}), exact at 3 ranks; respawn RPC "
          f"{lead['respawn_rpc_ms']} ms; the replacement's start-up: imports "
          f"{repl[0]['legs']['imports_s']} s, CUDA init "
          f"{repl[0]['legs']['cuda_init_s']} s, host_init (rejoin, FT_JOIN) "
          f"{repl[0]['legs']['host_init_s']} s; respawn to rejoin "
          f"{[x['respawn_to_rejoin_ms'] for x in surv]} ms; exact at 4 ranks again; "
          f"phase {res['s']} s on {card_line}")
    return res


def _serve_tokens(np, cfg):
    """The SERVE_REQUESTS request sequences, from one seed."""
    rng = np.random.default_rng(SERVE_SEED + 1)
    return rng.integers(0, cfg.vocab, (SERVE_REQUESTS, cfg.seq), dtype=np.int64)


def _serve_scores(torch, F, tfm, params, tok, cfg):
    """Each row's mean next-token cross-entropy (f32) and last-position
    argmax, with the last position's f32 logits."""
    logits = tfm.forward(params, tok, cfg)
    n = tok.shape[0]
    ce = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]).float(),
                         tok[:, 1:].reshape(-1), reduction="none").view(n, -1).mean(1)
    last = logits[:, -1].float()
    return ce, last.argmax(-1), last


def _serve_param_shapes(cfg) -> dict:
    D, Fd, V, L = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.n_layers
    return {"embed": (V, D), "wqkv": (L, D, 3, D), "wo": (L, D, D), "w1": (L, D, Fd),
            "w2": (L, Fd, D), "ln1": (L, D), "ln2": (L, D), "lnf": (D,)}


def serve_child(mode: str) -> int:
    """Phase 20's child: one rank of the daemon-hosted serving job (see the
    module doc).  ``mode`` is ``kill`` or ``elastic``.  Prints one
    ``SERVE {json}`` line."""
    import signal
    import threading

    import numpy as np
    import torch
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.ft import recovery
    from zhpe_ompi_tpu_torch.models import inferloop
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_norm
    from zhpe_ompi_tpu_torch.parallel.hybrid import dcn_bcast_params
    from zhpe_ompi_tpu_torch.runtime import spc

    legs = {"imports_s": time.time() - _T0}
    on_card = SERVE_DEVICE == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t = time.time()
    torch.zeros(1, device=SERVE_DEVICE)
    if on_card:
        fused_norm._lib()
        fa._lib()
    legs["cuda_and_kernel_load_s"] = time.time() - t
    rejoin = os.environ.get("ZMPI_REJOIN") == "1"
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    if rejoin:
        # a replacement (or a grown rank) holds no parameters: rank 0's
        # arrive in remesh_fn; NaN until then
        params = {k: torch.full(s, float("nan"), device=SERVE_DEVICE)
                  for k, s in _serve_param_shapes(cfg).items()}
    else:
        params = tfm.params_from_numpy(numpy_params(cfg, SERVE_SEED), cfg,
                                       device=SERVE_DEVICE)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    forwards, rows_run, detail = [], [0], []

    def counted_forward(tok):
        """One forward and its scores, this thread's kernel launches
        recorded."""
        before = _build.thread_launches()
        scored = _serve_scores(torch, F, tfm, params, tok, cfg)
        after = _build.thread_launches()
        forwards.append({k: v - before.get(k, 0) for k, v in after.items()
                         if v != before.get(k, 0)})
        return scored

    # one forward at the serving shape before joining (its lazy library
    # and allocator set-up out of the served steps; on a replacement's NaN
    # parameters as well)
    t = time.time()
    counted_forward(torch.zeros((SERVE_BURST // SERVE_RANKS, cfg.seq),
                                dtype=torch.int64, device=SERVE_DEVICE))
    sync()
    legs["warmup_forward_s"] = time.time() - t
    t = time.time()
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    legs["host_init_s"] = time.time() - t
    ep.set_errhandler(errh.ERRORS_RETURN)
    seen = {}
    ep.ft_state.add_failure_listener(
        lambda rank, cause: seen.setdefault(rank, [time.time(), cause]))
    out = {"rank": ep.rank, "mode": mode, "rejoin": rejoin, "legs": legs}

    def infer_fn(live, state, batch):
        rows = batch[live.rank::live.size]
        mine = []
        t0 = time.perf_counter()
        if rows:
            rows_run[0] += 1
            if (mode == "kill" and not rejoin and ep.rank == SERVE_VICTIM
                    and rows_run[0] == SERVE_KILL_STEP):
                print("SERVE-KILL " + json.dumps({"t": time.time()}), flush=True)
                os.kill(os.getpid(), signal.SIGKILL)  # with a batch in flight
            ce, arg, _ = counted_forward(torch.stack(rows).to(SERVE_DEVICE))
            mine = [[c, a] for c, a in zip(ce.tolist(), arg.tolist())]
        t1 = time.perf_counter()
        gathered = live.allgather(mine)
        # rows, this rank's forward and scores (ms, to the host), the
        # allgather (ms, waiting for the slowest rank included)
        detail.append([len(rows), (t1 - t0) * 1e3,
                       (time.perf_counter() - t1) * 1e3])
        return state, [gathered[i % live.size][i // live.size]
                       for i in range(len(batch))]

    pending = [rejoin]

    def remesh_fn(live, state):
        """Rank 0's parameters to every member that lacks them (a
        replacement, a grown rank): one host-plane broadcast, or nothing
        when every member holds them."""
        if live.allreduce(int(pending[0]), zmpi.SUM) == 0:
            return
        out.setdefault("t_remesh", time.time())
        sync()
        t0 = time.perf_counter()
        new = dcn_bcast_params(live, state, root=0)
        for k in state:
            state[k].copy_(new[k])
        sync()
        out["bcast_ms"] = (time.perf_counter() - t0) * 1e3
        pending[0] = False

    def respawner(victims):
        t0 = time.time()
        pids = recovery.daemon_respawn(victims, timeout=SERVE_REJOIN_S)
        out["respawn_rpc"] = [t0, time.time()]
        return pids

    ses = (recovery.ElasticSession(ep, timeout=SERVE_REJOIN_S)
           if mode == "elastic" else None)
    loop = inferloop.FtInferLoop(ep, infer_fn=infer_fn, state=params,
                                 batch_max=SERVE_BURST, elastic=ses,
                                 respawner=respawner, remesh_fn=remesh_fn,
                                 rejoin_timeout=SERVE_REJOIN_S)
    if rejoin:
        remesh_fn(loop.live, params)
    step_ms, membership = [], [(0, 0)]
    plain_step = loop.serve_step

    def timed_step():
        """One serve step timed (admit to resolve); a served step is
        marked when the membership changed (a recovery, a resize) since
        the last served one: it waits for the new members to catch up."""
        t0 = time.perf_counter()
        act = plain_step()
        if act == "served":
            now = (loop.recoveries, loop.resizes)
            step_ms.append([(time.perf_counter() - t0) * 1e3,
                            now != membership[0]])
            membership[0] = now
        return act

    loop.serve_step = timed_step
    if ep.rank == 0 and not rejoin:
        # rank 0 serves on this thread (the one its warm-up forward ran
        # on); a client thread submits the bursts and waits their tickets
        toks = torch.from_numpy(_serve_tokens(np, cfg))
        tickets, failed = [], []

        def wait_all(got, t_sub):
            for i, tk in got:
                val = tk.result(SERVE_JOB_S)
                tickets.append({"i": i, "ce": val[0], "arg": val[1],
                                "status": tk.status, "requeues": tk.requeues,
                                "latency_ms": (time.time() - t_sub) * 1e3})

        def burst(lo, hi):
            t_sub = time.time()
            wait_all([(i, loop.queue.submit(toks[i])) for i in range(lo, hi)],
                     t_sub)

        def client(pre):
            try:
                if mode == "kill":
                    for b in range(SERVE_REQUESTS // SERVE_BURST):
                        burst(b * SERVE_BURST, (b + 1) * SERVE_BURST)
                else:
                    wait_all(*pre)
                    deadline = time.monotonic() + SERVE_REJOIN_S
                    while loop.resizes < 1 and time.monotonic() < deadline:
                        time.sleep(0.05)
                    burst(SERVE_ELASTIC_BURST, SERVE_ELASTIC_BURST + SERVE_BURST)
            except BaseException as e:  # noqa: BLE001 - reported in the result
                failed.append(f"{type(e).__name__}: {e}")
            finally:
                loop.stop()

        served0 = spc.read("infer_requests_served")
        t_first = time.time()
        pre = None
        if mode == "elastic":
            # the burst's backlog is published before the loop serves it,
            # so the controller's policy sees it and votes
            pre = ([(i, loop.queue.submit(toks[i]))
                    for i in range(SERVE_ELASTIC_BURST)], time.time())
            time.sleep(SERVE_ELASTIC_HOLD_S)
        submitter = threading.Thread(target=client, args=(pre,),
                                     name="serve-client")
        submitter.start()
        out["act"] = loop.serve()
        submitter.join(SERVE_JOB_S)
        out["serve_s"] = time.time() - t_first
        out.update(tickets=tickets, client_errors=failed, served=loop.served,
                   served_counter=spc.read("infer_requests_served") - served0,
                   requeues=spc.read("infer_requeues"), recoveries=loop.recoveries,
                   resizes=loop.resizes, live=loop.live.size)
    else:
        out["act"] = loop.serve()
    out.update(step_ms=step_ms, detail=detail, forwards=forwards, steps=loop.steps,
               peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0,
               digest=_params_digest(torch, params),
               cause=seen.get(SERVE_VICTIM), live_end=loop.live.size,
               threads=inferloop.live_worker_threads(),
               parked=inferloop.parked_tickets())
    if ses is not None:
        ses.close()
    zmpi.host_finalize()
    print("SERVE " + json.dumps(out), flush=True)
    return 0


def _serve_reference(torch, F, np, tfm, cfg):
    """The smoke's own forward of the SERVE_REQUESTS sequences on the card,
    in batches of SERVE_BURST: (ce, argmax, last-position logits)."""
    from zhpe_ompi_tpu_torch.bench import numpy_params

    params = tfm.params_from_numpy(numpy_params(cfg, SERVE_SEED), cfg,
                                   device=SERVE_DEVICE)
    toks = torch.from_numpy(_serve_tokens(np, cfg)).to(SERVE_DEVICE)
    ce, arg, last = [], [], []
    with torch.no_grad():
        for lo in range(0, SERVE_REQUESTS, SERVE_BURST):
            c, a, lg = _serve_scores(torch, F, tfm, params, toks[lo:lo + SERVE_BURST],
                                     cfg)
            ce.append(c)
            arg.append(a)
            last.append(lg)
    return (torch.cat(ce).tolist(), torch.cat(arg).tolist(), torch.cat(last).cpu(),
            _params_digest(torch, params))


def _serve_agreement(tickets, ref, n_expected, label):
    """Every ticket served once, each value against the reference: the mean
    CE within SERVE_CE_TOL, the argmax equal unless the reference's top two
    logits are within SERVE_ARGMAX_TOL of each other."""
    ref_ce, ref_arg, ref_last, _ = ref
    idx = sorted(t["i"] for t in tickets)
    if idx != list(range(n_expected)) or any(t["status"] != "served" for t in tickets):
        raise SystemExit(f"serve {label}: tickets {idx} "
                         f"{[t['status'] for t in tickets]}")
    worst, ties = 0.0, 0
    for t in tickets:
        i = t["i"]
        worst = max(worst, abs(t["ce"] - ref_ce[i]))
        if t["arg"] != ref_arg[i]:
            gap = float(ref_last[i, ref_arg[i]] - ref_last[i, t["arg"]])
            if gap > SERVE_ARGMAX_TOL:
                raise SystemExit(f"serve {label}: request {i} argmax {t['arg']} vs "
                                 f"{ref_arg[i]} (logit gap {gap})")
            ties += 1
    if worst > SERVE_CE_TOL:
        raise SystemExit(f"serve {label}: mean CE differs by {worst} "
                         f"(tolerance {SERVE_CE_TOL})")
    return {"ce_max_abs_err": worst, "argmax_ties": ties}


def _serve_launch_gate(rows, label):
    """Every forward a rank ran launched the layernorm forward 2L + 1 and
    the flash forward L times by that thread's own tally, and nothing
    else; every rank ran at least one forward."""
    L = HEADLINE["n_layers"]
    want = ({"ln_fwd": 2 * L + 1, "flash_fwd": L} if SERVE_DEVICE == "cuda"
            else {})
    for x in rows:
        bad = [f for f in x["forwards"] if f != want]
        if bad or not x["forwards"]:
            raise SystemExit(f"serve {label}: rank {x['rank']} forwards launched "
                             f"{bad or x['forwards']} (expected {want} each)")
    return want


def _serve_stats(rank0):
    """Rank 0's served steps: the quartiles of all, and of the steady ones
    (no membership change since the previous served step), whose median
    gives requests/s and tokens/s."""
    every = _quartiles([ms for ms, _ in rank0["step_ms"]])
    q = _quartiles([ms for ms, changed in rank0["step_ms"] if not changed])
    rps = SERVE_BURST / (q["median"] / 1e3)
    return q, every, rps, rps * HEADLINE["seq"]


def drive_serve(torch, np, tfm, card_line) -> dict:
    """Phase 20: the serving loop over a daemon-hosted job (see the module
    doc): the kill run, then the elastic grow."""
    import torch.nn.functional as F

    from zhpe_ompi_tpu_torch.models import inferloop

    t_phase = time.perf_counter()
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    ref = _serve_reference(torch, F, np, tfm, cfg)
    if SERVE_DEVICE == "cuda":
        torch.cuda.empty_cache()

    # the kill run
    rc, text, err, deltas, stat, session, _ = _dvm_launch(
        SERVE_RANKS, ["--serve-child", "kill"], SERVE_MCA, metrics=True,
        timeout=SERVE_JOB_S)
    rows = _child_json(text, "SERVE")
    kills = _child_json(text, "SERVE-KILL")
    if rc != 0 or len(rows) != SERVE_RANKS or len(kills) != 1:
        raise SystemExit(f"serve kill: rc {rc}, {len(rows)} results, {len(kills)} "
                         f"kills\n{text[-3000:]}\n{_rank_tails(err)}")
    r0 = next(x for x in rows if x["rank"] == 0 and not x["rejoin"])
    surv = [x for x in rows if not x["rejoin"]]
    repl = [x for x in rows if x["rejoin"]]
    if not (len(repl) == 1 and repl[0]["rank"] == SERVE_VICTIM):
        raise SystemExit(f"serve kill: replacement {repl}")
    if r0["client_errors"]:
        raise SystemExit(f"serve kill: rank 0's client {r0['client_errors']}")
    agree = _serve_agreement(r0["tickets"], ref, SERVE_REQUESTS, "kill")
    want = _serve_launch_gate(rows, "kill")
    if not (r0["served"] == r0["served_counter"] == SERVE_REQUESTS
            and any(t["requeues"] >= 1 for t in r0["tickets"]) and r0["requeues"] >= 1
            and r0["recoveries"] == 1 and r0["live"] == SERVE_RANKS):
        raise SystemExit(f"serve kill: rank 0 {dict((k, r0[k]) for k in ('served', 'served_counter', 'requeues', 'recoveries', 'live'))}")
    if any(x["cause"] is None or x["cause"][1] != "daemon" for x in surv):
        raise SystemExit(f"serve kill: classification {[x['cause'] for x in surv]}")
    if deltas["dvm_fault_events"] != 1 or deltas["dvm_respawns"] != 1 \
            or stat["pmix"] != {}:
        raise SystemExit(f"serve kill: daemon {deltas}, store {stat['pmix']}")
    if repl[0]["digest"] != r0["digest"] or r0["digest"] != ref[3]:
        raise SystemExit("serve kill: the replacement's parameters are not rank 0's")
    if any(x["threads"] or x["parked"] or x["live_end"] != SERVE_RANKS for x in rows):
        raise SystemExit(f"serve kill: leftovers {[(x['threads'], x['parked']) for x in rows]}")
    _no_ring_files(session)
    t_kill = kills[0]["t"]
    classify_ms = [(x["cause"][0] - t_kill) * 1e3 for x in surv]
    rpc = r0["respawn_rpc"]
    requeued = [t["latency_ms"] for t in r0["tickets"] if t["requeues"]]
    plain = [t["latency_ms"] for t in r0["tickets"] if not t["requeues"]]
    q, q_all, rps, tps = _serve_stats(r0)
    kill_legs = {
        "kill_to_classify_ms": classify_ms,
        "agree_ms": (rpc[0] - r0["cause"][0]) * 1e3,
        "respawn_rpc_ms": (rpc[1] - rpc[0]) * 1e3,
        "replacement_startup_s": repl[0]["legs"],
        "replacement_remesh_after_rpc_ms": (repl[0]["t_remesh"] - rpc[1]) * 1e3,
        "params_bcast_ms": {"rank0": r0.get("bcast_ms"), "replacement": repl[0]["bcast_ms"]},
        "requeued_extra_latency_ms": (_median(requeued) - _median(plain)),
    }
    kill_report = {
        "step_ms": q, "step_ms_all": q_all, "requests_per_s": rps,
        "tokens_per_s": tps, "overall_requests_per_s": SERVE_REQUESTS / r0["serve_s"],
        "legs": kill_legs, "agreement": agree, "daemon": deltas,
        "peak_bytes": [x["peak_bytes"] for x in rows],
        "launches_per_forward": want, "forwards": {x["rank"]: len(x["forwards"]) for x in rows},
        "rank0_steps": {"ms": r0["step_ms"], "rows_forward_allgather_ms": r0["detail"]},
    }

    # the elastic grow: 2 ranks of a max_size 4 job; the controller here
    ctl_out = {}

    def controller(addr, out, err):
        from zhpe_ompi_tpu_torch.runtime import dvm as dvm_mod

        cli = dvm_mod.DvmClient(addr)
        try:
            deadline = time.monotonic() + SERVE_JOB_S
            while not cli.stat()["jobs"]:
                if time.monotonic() > deadline:
                    raise SystemExit(f"serve elastic: no job\n{err.getvalue()[-4000:]}")
                time.sleep(0.05)
            job = next(iter(cli.stat()["jobs"]))
            lc = inferloop.LoadController(cli, job, policy=inferloop.QueueDepthPolicy(
                high=SERVE_BURST // 2, low=-1, patience=1, cooldown=1 << 30,
                max_size=SERVE_RANKS, step=SERVE_RANKS - SERVE_ELASTIC_START),
                resize_timeout=SERVE_JOB_S)
            while not lc.applied and time.monotonic() < deadline:
                t_vote = time.time()
                if lc.tick() is not None:
                    ctl_out["t_vote"] = t_vote
                    break
                time.sleep(0.1)
            ctl_out["applied"] = lc.applied
        finally:
            cli.close()

    rc, text, err, deltas, stat, session, _ = _dvm_launch(
        SERVE_ELASTIC_START, ["--serve-child", "elastic"], SERVE_MCA, metrics=True,
        max_size=SERVE_RANKS, timeout=SERVE_JOB_S, controller=controller)
    rows = _child_json(text, "SERVE")
    if rc != 0 or len(rows) != SERVE_RANKS or not ctl_out.get("applied"):
        raise SystemExit(f"serve elastic: rc {rc}, {len(rows)} results, controller "
                         f"{ctl_out}\n{text[-3000:]}\n{_rank_tails(err)}")
    e0 = next(x for x in rows if x["rank"] == 0)
    grown = sorted(x["rank"] for x in rows if x["rejoin"])
    if e0["client_errors"]:
        raise SystemExit(f"serve elastic: rank 0's client {e0['client_errors']}")
    eagree = _serve_agreement(e0["tickets"], ref, SERVE_ELASTIC_BURST + SERVE_BURST,
                              "elastic")
    _serve_launch_gate(rows, "elastic")
    if not (ctl_out["applied"][0]["grown"] == grown == [2, 3] and e0["resizes"] >= 1
            and e0["live"] == SERVE_RANKS and deltas["dvm_resizes"] == 1
            and stat["pmix"] == {}
            and all(x["digest"] == e0["digest"] for x in rows)
            and all(not x["threads"] and not x["parked"] for x in rows)):
        raise SystemExit(f"serve elastic: grown {grown}, controller {ctl_out}, rank 0 "
                         f"resizes {e0['resizes']} live {e0['live']}, daemon {deltas}")
    _no_ring_files(session)
    eq, eq_all, erps, etps = _serve_stats(e0)
    elastic_report = {
        "step_ms": eq, "step_ms_all": eq_all, "requests_per_s": erps,
        "tokens_per_s": etps,
        "vote_to_adopt_ms": (e0["t_remesh"] - ctl_out["t_vote"]) * 1e3,
        "params_bcast_ms": e0.get("bcast_ms"),
        "grown_startup_s": [x["legs"] for x in rows if x["rejoin"]],
        "agreement": eagree, "daemon": deltas,
        "peak_bytes": [x["peak_bytes"] for x in rows],
        "rank0_steps": {"ms": e0["step_ms"], "rows_forward_allgather_ms": e0["detail"]}}
    report = {"kill": kill_report, "elastic": elastic_report,
              "launches_per_step_and_rank": want,
              "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"serve": report, "card": card_line}))
    print(f"serve ({SERVE_RANKS} daemon-hosted ranks, flagship width, batches of "
          f"{SERVE_BURST}): a steady step {q['median']} ms (q1 {q['q1']}, q3 "
          f"{q['q3']}, n {q['n']}; every step {q_all}), {rps} requests/s, {tps} "
          f"tokens/s; kill to classification "
          f"{classify_ms} ms; agree {kill_legs['agree_ms']} ms, respawn RPC "
          f"{kill_legs['respawn_rpc_ms']} ms, the replacement's imports "
          f"{repl[0]['legs']['imports_s']} s + CUDA and kernel load "
          f"{repl[0]['legs']['cuda_and_kernel_load_s']} s + a warm-up forward "
          f"{repl[0]['legs']['warmup_forward_s']} s + host_init (FT_JOIN) "
          f"{repl[0]['legs']['host_init_s']} s, parameters re-broadcast "
          f"{repl[0]['bcast_ms']} ms; requeued tickets' extra latency "
          f"{kill_legs['requeued_extra_latency_ms']} ms; CE max err "
          f"{agree['ce_max_abs_err']} (tol {SERVE_CE_TOL}); elastic: a steady "
          f"step {eq['median']} ms (every step {eq_all}), vote to adopted resize "
          f"{elastic_report['vote_to_adopt_ms']} ms; peak bytes "
          f"{kill_report['peak_bytes']}; phase {report['phase_s']} s on {card_line}")
    return report


# -- phase 21: one-sided, PGAS, MPI-IO and dynamic processes -----------------


def _osc_tokens(np, cfg):
    """Phase 21's batch: (tokens, targets) of OSC_BATCH rows, one seed."""
    rng = np.random.default_rng(OSC_SEED + 1)
    return tuple(rng.integers(0, cfg.vocab, (OSC_BATCH, cfg.seq), dtype=np.int64)
                 for _ in range(2))


def _osc_ce(torch, F, tfm, params, tok, tgt, cfg):
    """Per-token cross-entropy (f32, rows x seq) of one forward."""
    logits = tfm.forward(params, tok, cfg)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           tgt.reshape(-1), reduction="none").view(tok.shape)


def _shm_bytes() -> tuple[int, str]:
    """(available bytes, ``df`` line) of the segment directory (/dev/shm)."""
    from zhpe_ompi_tpu_torch.pt2pt import sm

    d = sm.segment_dir()
    st = os.statvfs(d)
    out = subprocess.run(["df", "-B1", d], capture_output=True, text=True,
                         timeout=60)
    return st.f_bavail * st.f_frsize, out.stdout.strip().splitlines()[-1]


def osc_io_spawned(proc, parent) -> None:
    """Phase 21's spawned child (``dpm_wire.spawn`` pickles it by name):
    it receives the CE file's path and element count by the parents'
    bcast, reads its half with its own ``WireFile.read_all`` and returns
    the float64 sum through the intercomm's allreduce."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from zhpe_ompi_tpu_torch import ops
    from zhpe_ompi_tpu_torch.datatype import FLOAT
    from zhpe_ompi_tpu_torch.io import file as iofile
    from zhpe_ompi_tpu_torch.io.wirefile import WireFile

    path, count = parent.bcast(None, root=0)
    half = count // proc.size
    with WireFile(proc, path, iofile.MODE_RDONLY) as f:
        f.set_view(0, FLOAT)
        f.seek(proc.rank * half)
        mine = f.read_all(half)
    parent.allreduce(float(np.asarray(mine, np.float64).sum()), ops.SUM)
    parent.barrier()


def osc_io_child() -> int:
    """Phase 21's child: one rank of the job through ``zmpi.host_init``
    (see the module doc); prints one JSON line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build, ops
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.coll import inter
    from zhpe_ompi_tpu_torch.comm import dpm_wire
    from zhpe_ompi_tpu_torch.datatype import FLOAT
    from zhpe_ompi_tpu_torch.io import file as iofile
    from zhpe_ompi_tpu_torch.io.wirefile import WireFile
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.osc import direct
    from zhpe_ompi_tpu_torch.runtime import spc
    from zhpe_ompi_tpu_torch.shmem import spml

    on_card = OSC_DEVICE == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r, n = ep.rank, ep.size
    out = {"rank": r, "sm": ep._sm_seg is not None}
    names = sorted(_serve_param_shapes(cfg))
    # the CUDA context first: its start-up is no part of a copy's time
    torch.zeros(1, device=OSC_DEVICE)
    sync()
    counters = ("osc_direct_bytes", "osc_direct_gets", "osc_am_fallbacks",
                "osc_am_applied", "osc_gets", "tcp_bytes_sent", "sm_bytes_sent")

    def snap():
        return {k: spc.read(k) for k in counters}

    def delta(a, b):
        return {k: b[k] - a[k] for k in counters}

    # 1. the weights by RMA: rank 0 stages them through a pinned buffer,
    # every rank pulls them from its window region and copies them to the card
    if r == 0:
        params0 = tfm.params_from_numpy(numpy_params(cfg, OSC_SEED), cfg,
                                        device=OSC_DEVICE)
        total = sum(params0[k].numel() for k in names)
        t = time.perf_counter()
        staged = torch.empty(total, dtype=torch.float32, pin_memory=on_card)
        off = 0
        for k in names:
            m = params0[k].numel()
            staged[off:off + m].copy_(params0[k].reshape(-1), non_blocking=True)
            off += m
        sync()
        out["stage_d2h_ms"] = (time.perf_counter() - t) * 1e3
        out["digest0"] = _params_digest(torch, params0)
        del params0
        shm_free, _ = _shm_bytes()
        chunk = min(total, max(1 << 18, (shm_free - (32 << 20)) // 8))
        ep.bcast((total, chunk), root=0)
    else:
        staged = None
        total, chunk = ep.bcast(None, root=0)
    out["payload_bytes"], out["region_bytes"] = total * 4, chunk * 4
    win = direct.allocate_window(ep, chunk * 4 if r == 0 else 0, np.float32)
    out["direct_capable"] = win._direct_capable
    # the pull lands in a pinned host buffer (window_bcast's out=), whence
    # one copy takes it to the card
    host = torch.empty(total, dtype=torch.float32, pin_memory=on_card)
    c0 = snap()
    t = time.perf_counter()
    for lo in range(0, total, chunk):
        direct.window_bcast(win, staged[lo:lo + chunk] if r == 0 else None,
                            root=0, out=host[lo:lo + chunk])
        if chunk < total:
            ep.barrier()  # every pull done before rank 0 stores the next part
    out["pull_ms"] = (time.perf_counter() - t) * 1e3
    ep.barrier()
    out["rma"] = delta(c0, snap())
    if chunk == total:
        # the mapped load alone: the pull above also waits for rank 0's
        # store into fresh tmpfs pages
        t = time.perf_counter()
        win.get(0, 0, total, out=host)
        out["load_ms"] = (time.perf_counter() - t) * 1e3
    ep.barrier()
    win.free()
    t = time.perf_counter()
    flat = host.to(OSC_DEVICE, non_blocking=True)
    sync()
    out["h2d_ms"] = (time.perf_counter() - t) * 1e3
    params, off = {}, 0
    for k, shape in ((k, _serve_param_shapes(cfg)[k]) for k in names):
        m = math.prod(shape)
        params[k] = flat[off:off + m].view(shape)
        off += m
    out["digest"] = _params_digest(torch, params)
    del host, staged

    # 2. the AM contrast: the same window_bcast with the direct plane off
    mca_var.set_var("osc_direct", 0)
    try:
        am_elems = OSC_AM_BYTES // 4
        awin = direct.allocate_window(ep, OSC_AM_BYTES if r == 0 else 0, np.float32)
        c0 = snap()
        t = time.perf_counter()
        got = direct.window_bcast(
            awin, flat[:am_elems].cpu() if r == 0 else None, root=0)
        out["am_ms"] = (time.perf_counter() - t) * 1e3
        ep.barrier()  # rank 0's service has answered every pull
        out["am"] = delta(c0, snap())
        out["am_payload_bytes"] = int(got.nbytes)
        out["am_exact"] = bool(np.array_equal(got, flat[:am_elems].cpu().numpy()))
        out["am_direct_capable"] = awin._direct_capable
        awin.free()
    finally:
        mca_var.unset("osc_direct")

    # 3. the forward on this rank's rows, its kernel launches by this
    # thread's tally
    tok, tgt = (torch.from_numpy(a[r * OSC_ROWS:(r + 1) * OSC_ROWS]).to(OSC_DEVICE)
                for a in _osc_tokens(np, cfg))
    with torch.no_grad():
        _osc_ce(torch, F, tfm, params, tok, tgt, cfg)  # the libraries' set-up
        sync()
        before = _build.thread_launches()
        t = time.perf_counter()
        ce = _osc_ce(torch, F, tfm, params, tok, tgt, cfg)
        sync()
        out["forward_ms"] = (time.perf_counter() - t) * 1e3
        after = _build.thread_launches()
    out["launches"] = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
    ce_host = ce.cpu().numpy().astype(np.float32)

    # 4. MPI-IO: the CE rows at this rank's displacement, then one shared-
    # pointer record each
    path = os.environ["ZMPI_OSC_FILE"]
    t = time.perf_counter()
    with WireFile(ep, path, iofile.MODE_CREATE | iofile.MODE_RDWR) as f:
        f.set_view(r * ce_host.nbytes, FLOAT)
        f.write_all(ce_host)
        f.set_view(0, FLOAT)
        f.seek_shared(OSC_BATCH * cfg.seq)
        f.write_shared(np.array([r, ce_host.size, ce_host.astype(np.float64).sum(), 0],
                                np.float32))
        ep.barrier()
        out["shared_end"] = f.tell_shared()
    out["io_ms"] = (time.perf_counter() - t) * 1e3

    # 5. PGAS: every rank adds its scored tokens to rank 0's counter
    pe = spml.shmem_pe(ep, heap_bytes=1 << 16)
    out["spml"] = spml.select_spml(ep).name
    out["pe_backend"] = type(pe._backend).__name__
    cnt = pe.shmalloc(1, np.int64)
    pe.local(cnt)[...] = 0
    pe.barrier_all()
    pe.atomic_add(cnt, int(ce_host.size), 0)
    pe.barrier_all()
    out["pgas_counter"] = int(pe.atomic_fetch(cnt, 0))
    pe.finalize()

    # 6. dynamic processes: 2 spawned children read the CE file and return
    # its sum over the intercomm
    t = time.perf_counter()
    ic, handle = dpm_wire.spawn(ep, osc_io_spawned, n_children=OSC_SPAWN,
                                timeout=HOST_TIMEOUT_S)
    out["spawn_to_connected_ms"] = (time.perf_counter() - t) * 1e3
    root = inter.ROOT if r == 0 else inter.PROC_NULL
    ic.bcast((path, OSC_BATCH * cfg.seq) if r == 0 else None, root=root)
    out["children_sum"] = float(ic.allreduce(0.0, ops.SUM))
    ic.barrier()
    if r == 0:
        handle.join(HOST_TIMEOUT_S)
        with open(path, "rb") as fh:
            raw = np.frombuffer(fh.read(), np.float32)
        out["own_sum"] = float(raw[:OSC_BATCH * cfg.seq].astype(np.float64).sum())
    ep.barrier()
    zmpi.host_finalize()
    print(json.dumps(out))
    return 0


def drive_osc_io(torch, np, tfm, card_line) -> dict:
    """Phase 21: OSC_RANKS children of this script (``--osc-io-child``)
    through ``zmpi.host_init`` with the sm var at its default (this process
    hosts the rendezvous), each with the flagship on the card (see the
    module doc).  Fails unless every gate holds."""
    import socket

    import torch.nn.functional as F

    from zhpe_ompi_tpu_torch.bench import numpy_params

    t_phase = time.perf_counter()
    shm_free, df_line = _shm_bytes()
    print(f"osc_io: df /dev/shm: {df_line}")
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(OSC_RANKS)
    srv.settimeout(HOST_TIMEOUT_S)
    host, port = srv.getsockname()
    tmp = tempfile.mkdtemp(prefix="osc_io_")
    path = os.path.join(tmp, "ce.bin")
    env = dict(os.environ, ZMPI_SIZE=str(OSC_RANKS), ZMPI_COORD_HOST=host,
               ZMPI_COORD_PORT=str(port), ZMPI_COORD_EXTERNAL="1",
               ZMPI_OSC_FILE=path)
    for k in ("ZMPI_PMIX", "ZMPI_FT", "ZMPI_MCA_sm", "ZMPI_MCA_osc_direct"):
        env.pop(k, None)
    children = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--osc-io-child"],
        env=dict(env, ZMPI_RANK=str(r)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(OSC_RANKS)]
    try:
        _host_rendezvous(srv, OSC_RANKS)
        outs = [c.communicate(timeout=OSC_TIMEOUT_S) for c in children]
    finally:
        srv.close()
        for c in children:
            if c.poll() is None:
                c.kill()
                c.wait()
    res = []
    for r, (c, (out, err)) in enumerate(zip(children, outs)):
        lines = out.strip().splitlines()
        if c.returncode != 0 or not lines:
            raise SystemExit(f"osc_io: rank {r} exited {c.returncode}\n"
                             f"{out[-2000:]}\n{err[-4000:]}")
        res.append(json.loads(lines[-1]))
    with open(path, "rb") as fh:
        raw = np.frombuffer(fh.read(), np.float32).copy()
    for name in os.listdir(tmp):
        os.unlink(os.path.join(tmp, name))
    os.rmdir(tmp)

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    n_tok = OSC_BATCH * cfg.seq
    payload = res[0]["payload_bytes"]
    # 1. weights by RMA
    for x in res:
        if x["digest"] != res[0]["digest0"] or not x["sm"] or not x["direct_capable"]:
            raise SystemExit(f"osc_io: rank {x['rank']} parameters {x['digest']} vs "
                             f"{res[0]['digest0']} (sm {x['sm']}, direct "
                             f"{x['direct_capable']})")
        want = payload * (2 if x["rank"] == 0 else 1)
        rma = x["rma"]
        if rma["osc_direct_bytes"] != want or rma["osc_am_fallbacks"] != 0:
            raise SystemExit(f"osc_io: rank {x['rank']} direct bytes {rma} "
                             f"(expected {want}, no AM fallback)")
        if rma["tcp_bytes_sent"] + rma["sm_bytes_sent"] > OSC_CONTROL_BYTES:
            raise SystemExit(f"osc_io: rank {x['rank']} moved {rma} on the wire and "
                             f"rings during the direct pull (control only: at most "
                             f"{OSC_CONTROL_BYTES})")
    # 2. the AM contrast
    for x in res:
        am = x["am"]
        if not x["am_exact"] or x["am_direct_capable"] or am["osc_direct_bytes"]:
            raise SystemExit(f"osc_io: rank {x['rank']} AM contrast {am}")
    if res[0]["am"]["tcp_bytes_sent"] + res[0]["am"]["sm_bytes_sent"] < \
            (OSC_RANKS - 1) * res[0]["am_payload_bytes"]:
        raise SystemExit(f"osc_io: the AM replies did not carry the payload: "
                         f"{res[0]['am']}")
    # 3. the forward's launches
    want_l = {"ln_fwd": 2 * cfg.n_layers + 1, "flash_fwd": cfg.n_layers} \
        if OSC_DEVICE == "cuda" else {}
    for x in res:
        if x["launches"] != want_l:
            raise SystemExit(f"osc_io: rank {x['rank']} forward launched "
                             f"{x['launches']} (expected {want_l})")
    # 4. the CE file against this process's forward of all rows
    tok, tgt = (torch.from_numpy(a).to(OSC_DEVICE) for a in _osc_tokens(np, cfg))
    params = tfm.params_from_numpy(numpy_params(cfg, OSC_SEED), cfg, device=OSC_DEVICE)
    with torch.no_grad():
        ref = _osc_ce(torch, F, tfm, params, tok, tgt, cfg).cpu().numpy()
    del params
    ce = raw[:n_tok].reshape(OSC_BATCH, cfg.seq)
    if not np.isfinite(ce).all():
        raise SystemExit("osc_io: the CE file holds non-finite values")
    mean_err = abs(float(ce.mean()) - float(ref.mean()))
    row_err = float(np.abs(ce.mean(1) - ref.mean(1)).max())
    tok_err = float(np.abs(ce - ref).max())
    if mean_err > OSC_CE_TOL or row_err > OSC_CE_TOL:
        raise SystemExit(f"osc_io: the CE file's mean differs by {mean_err}, a row's "
                         f"by {row_err} (tolerance {OSC_CE_TOL})")
    recs = raw[n_tok:].reshape(-1, 4)
    if len(recs) != OSC_RANKS or sorted(recs[:, 0].tolist()) != list(range(OSC_RANKS)) \
            or any(x["shared_end"] != n_tok + 4 * OSC_RANKS for x in res):
        raise SystemExit(f"osc_io: shared-pointer records {recs.tolist()}")
    # 5. PGAS
    for x in res:
        if x["spml"] != "mmap" or x["pe_backend"] != "MmapBackend" \
                or x["pgas_counter"] != n_tok:
            raise SystemExit(f"osc_io: rank {x['rank']} PGAS {x['spml']} "
                             f"{x['pe_backend']} counter {x['pgas_counter']} "
                             f"(expected {n_tok})")
    # 6. the spawned children's sum
    own = res[0]["own_sum"]
    if any(abs(x["children_sum"] - own) > 1e-9 * abs(own) for x in res):
        raise SystemExit(f"osc_io: the children's sum {[x['children_sum'] for x in res]}"
                         f" vs rank 0's {own}")
    report = {
        "ranks": OSC_RANKS, "shm_free_bytes": shm_free,
        "payload_bytes": payload, "region_bytes": res[0]["region_bytes"],
        "stage_d2h_ms": res[0]["stage_d2h_ms"],
        "pull_ms": [x["pull_ms"] for x in res],
        "load_ms": [x.get("load_ms") for x in res],
        "h2d_ms": [x["h2d_ms"] for x in res],
        "rma_counters": [x["rma"] for x in res],
        "am_bytes": res[0]["am_payload_bytes"],
        "am_ms": [x["am_ms"] for x in res],
        "am_counters": [x["am"] for x in res],
        "forward_ms": [x["forward_ms"] for x in res],
        "launches_per_forward": res[0]["launches"],
        "ce_mean_abs_err": mean_err, "ce_row_max_abs_err": row_err,
        "ce_token_max_abs_err": tok_err, "ce_tol": OSC_CE_TOL,
        "shared_records": len(recs), "io_ms": [x["io_ms"] for x in res],
        "pgas_counter": res[0]["pgas_counter"],
        "spawn_to_connected_ms": [x["spawn_to_connected_ms"] for x in res],
        "children_sum": res[0]["children_sum"], "own_sum": own,
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"osc_io": report, "card": card_line}))
    print(f"osc_io ({OSC_RANKS} host_init ranks, flagship width): weights "
          f"{payload} B by direct RMA pull {report['pull_ms']} ms (the mapped load "
          f"alone {report['load_ms']} ms) and H2D "
          f"{report['h2d_ms']} ms per rank (region {report['region_bytes']} B); AM "
          f"contrast {report['am_bytes']} B in {report['am_ms']} ms; forward launches "
          f"{report['launches_per_forward']}; CE file vs one-process forward: mean "
          f"{mean_err}, row {row_err}, token {tok_err} (tolerance {OSC_CE_TOL}); "
          f"{len(recs)} shared records; PGAS counter {report['pgas_counter']}; "
          f"spawn-to-connected {report['spawn_to_connected_ms'][0]} ms; phase "
          f"{report['phase_s']} s on {card_line}")
    return report


def _tools_tokens(np, cfg):
    """Phase 22's batch: (tokens, targets) of TOOLS_BATCH rows, one seed."""
    rng = np.random.default_rng(TOOLS_SEED + 1)
    return tuple(rng.integers(0, cfg.vocab, (TOOLS_BATCH, cfg.seq), dtype=np.int64)
                 for _ in range(2))


def _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg, tp_comm=None):
    """Each row's mean next-token cross-entropy (f32) of one forward."""
    logits = tfm.forward(params, tok, cfg, tp_comm=tp_comm)
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                         tgt.reshape(-1), reduction="none")
    return ce.view(tok.shape).mean(1)


def _tools_wait(path, job=None, what="file"):
    """Wait for ``path`` to appear; fails at TOOLS_WAIT_S, or at once when
    ``job`` (a launch thread and its output) ended first."""
    deadline = time.monotonic() + TOOLS_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline or (job is not None and not job[0].is_alive()):
            tail = "" if job is None else \
                f"\n{job[1].getvalue()[-3000:]}\n{_rank_tails(job[2].getvalue(), 40)}"
            raise SystemExit(f"tools: {what} {path} never appeared{tail}")
        time.sleep(0.01)


def _tools_touch(path, text=""):
    with open(path + ".tmp", "w") as fh:
        fh.write(text)
    os.replace(path + ".tmp", path)


def _tools_names_child() -> int:
    """Phase 22's plain-launcher child: the name server, ``--mca``
    forwarding and a host-plane allreduce under ``tools/mpirun.launch``."""
    import socket

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.comm import dpm_wire

    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    out = {"rank": ep.rank, "size": ep.size,
           "eager": zmpi.mca_var.get("tcp_eager_limit", None)}
    service = "chip-smoke-tools"
    if ep.rank == 0:
        port = dpm_wire.open_port()
        dpm_wire.publish_name(service, port.name)
        ep.barrier()
        port._srv.settimeout(HOST_TIMEOUT_S)
        conn, _ = port._srv.accept()
        with conn:
            out["hello"] = b"".join(iter(lambda: conn.recv(64), b"")).decode()
        port.close()
        ep.barrier()
        dpm_wire.unpublish_name(service)
    else:
        ep.barrier()
        if ep.rank == ep.size - 1:
            name = dpm_wire.lookup_name(service)
            host, port_no = name.rsplit(":", 1)
            with socket.create_connection((host, int(port_no)), HOST_TIMEOUT_S) as c:
                c.sendall(f"hello from rank {ep.rank}".encode())
            out["looked_up"] = name
        ep.barrier()
    out["sum"] = ep.allreduce(ep.rank + 1, zmpi.SUM)
    zmpi.host_finalize()
    print("NAMES " + json.dumps(out), flush=True)
    return 0


def _tools_abort_child() -> int:
    """Phase 22's abort child: every rank up with the sm var at its default
    (ring files in the launcher's session), then the last rank exits 3 while
    the others wait in a receive the launcher must tear down."""
    import glob

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.pt2pt import sm

    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    ep.barrier()
    if ep.rank == ep.size - 1:
        session = os.environ["ZMPI_SESSION"]
        rings = glob.glob(os.path.join(sm.segment_dir(), f"zompi_pyring_{session}_*"))
        print("ABORT " + json.dumps({"rank": ep.rank, "session": session,
                                     "sm": ep._sm_seg is not None,
                                     "ring_files": len(rings),
                                     "t_exit": time.time()}), flush=True)
        os._exit(3)
    ep.recv(source=ep.size - 1, tag=0x7A)
    return 1


def _tools_traced_child(work) -> int:
    """Phase 22's daemon-hosted child (see the module doc): the flagship on
    the card, counted forwards through a PMPI interceptor and MPI_T
    sessions, the CE over the host plane, the clock sync, rank 0's
    checkpoints; prints one ``TOOLS {json}`` line, then holds until this
    process has read the job's store."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.runtime.checkpoint import Checkpointer
    from zhpe_ompi_tpu_torch.tools import mpit, pmpi, ztrace

    sync = torch.cuda.synchronize if TOOLS_DEVICE == "cuda" else (lambda: None)
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r = ep.rank
    job = os.environ["ZMPI_PMIX"].rsplit("/", 1)[1]
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    params = tfm.params_from_numpy(numpy_params(cfg, TOOLS_SEED), cfg,
                                   device=TOOLS_DEVICE)
    tok, tgt = (torch.from_numpy(a[r * TOOLS_ROWS:(r + 1) * TOOLS_ROWS]).to(TOOLS_DEVICE)
                for a in _tools_tokens(np, cfg))
    store = tempfile.mkdtemp(prefix="zmpi-tools-tp-")
    dist.init_process_group(TOOLS_BACKEND,
                            store=dist.FileStore(os.path.join(store, "s"), 1),
                            rank=0, world_size=1)
    # the monitoring component counts coll_<op>_calls: set before the
    # communicator composes its table
    mca_var.set_var("coll_monitoring_enable", True)
    out: dict = {"rank": r, "size": ep.size, "job": job}
    calls: dict = {}
    secs: dict = {}

    def interceptor(opname, comm, args, kwargs, call_next):
        t0 = time.perf_counter()
        try:
            return call_next()
        finally:
            calls[opname] = calls.get(opname, 0) + 1
            secs[opname] = secs.get(opname, 0.0) + time.perf_counter() - t0

    try:
        tp = zmpi.Communicator(name="tp")
        with torch.no_grad():
            _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg, tp)  # set-up
        sync()
        session = mpit.PvarSession()
        h_calls = session.handle_alloc("spc_coll_allreduce_calls")
        h_posted = session.handle_alloc("tcp_posted_recvs")
        # never started: its baseline is 0, so it reads the count itself
        h_fetch = session.handle_alloc("spc_tuned_table_store_fetches")
        pmpi.attach(interceptor)
        h_calls.start()
        fwd_ms, launches, totals, rows = [], [], [], None
        try:
            for i in range(TOOLS_FORWARDS):
                if i == 1:
                    # the first forward's host-plane traffic is out: this
                    # process's reader starts its remote session on rank 0
                    if r == 0:
                        _tools_touch(os.path.join(work, "ready"), job)
                    _tools_wait(os.path.join(work, "go"))
                before = _build.thread_launches()
                sync()
                t = time.perf_counter()
                with torch.no_grad():
                    row_ce = _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg, tp)
                sync()
                fwd_ms.append((time.perf_counter() - t) * 1e3)
                after = _build.thread_launches()
                launches.append({k: v - before.get(k, 0) for k, v in after.items()
                                 if v != before.get(k, 0)})
                mine = row_ce.double().cpu().numpy()
                totals.append(float(ep.iallreduce(float(mine.sum()), zmpi.SUM).wait()))
                rows = ep.iallgather(mine.tolist()).wait()
        finally:
            pmpi.detach(interceptor)
        out["calls_by_op"] = calls
        out["interceptor_us"] = {op: secs[op] / calls[op] * 1e6 for op in calls}
        out["want_calls"] = {"allreduce": 2 * cfg.n_layers * TOOLS_FORWARDS}
        out["pvar_allreduce_calls"] = h_calls.read()
        out["tcp_posted_recvs"] = h_posted.read()
        out["tuned_table_store_fetches"] = h_fetch.read()
        session.free()
        out["forward_ms"], out["launches"] = fwd_ms, launches
        out["row_ce"] = [x for part in rows for x in part]
        out["total_ce"] = totals
        out["clock_offsets"] = ztrace.publish_clock_sync(ep)
        if r == 0:
            ck = Checkpointer(os.path.join(work, "ckpt"), keep=5)
            t = time.perf_counter()
            for step in (1, 2):
                ck.save(step, {"params": params}, blocking=True)
            out["checkpoint_ms"] = (time.perf_counter() - t) * 1e3
    finally:
        mca_var.unset("coll_monitoring_enable")
        dist.destroy_process_group()
    print("TOOLS " + json.dumps(out), flush=True)
    _tools_touch(os.path.join(work, f"finished_{r}"))
    _tools_wait(os.path.join(work, "release"))
    zmpi.host_finalize()
    return 0


def tools_child(mode: str, work: str | None = None) -> int:
    """Phase 22's children: ``traced`` (daemon-hosted, ``work`` its
    handshake directory), ``names`` and ``abort`` (under
    ``tools/mpirun.launch``)."""
    print(f"TOOLS-START rank {os.environ.get('ZMPI_RANK')}", flush=True)
    if mode == "names":
        return _tools_names_child()
    if mode == "abort":
        return _tools_abort_child()
    return _tools_traced_child(work)


class _FirstLine:
    """An IOF sink that keeps what the launcher forwards and the monotonic
    time of its first line."""

    def __init__(self):
        import io

        self.buf, self.first = io.StringIO(), None

    def write(self, text):
        if self.first is None:
            self.first = time.monotonic()
        self.buf.write(text)

    def flush(self):
        pass

    def getvalue(self):
        return self.buf.getvalue()


def _tools_plain(mpirun, kind, mca=None) -> dict:
    """One plain ``mpirun.launch`` of TOOLS_RANKS ``--tools-child kind``
    ranks: rc, output, spawn-to-first-line ms, the wall time it returned."""
    out, err = _FirstLine(), _FirstLine()
    t0 = time.monotonic()
    rc = mpirun.launch(TOOLS_RANKS, [os.path.abspath(__file__), "--tools-child", kind],
                       mca=mca, stdout=out, stderr=err, timeout=TOOLS_WAIT_S)
    t_return = time.time()
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue(),
            "first_line_ms": None if out.first is None else (out.first - t0) * 1e3,
            "t_return": t_return}


def _tools_pmpi_host_us(torch, dist, zmpi, pmpi) -> dict:
    """Host µs per ``Communicator.allreduce`` (1024 floats, one-rank
    communicator) with no interceptor and with a pass-through one attached,
    in alternating turns."""
    def passthrough(opname, comm, args, kwargs, call_next):
        return call_next()

    got: dict = {"none": [], "attached": []}
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            TOOLS_BACKEND, store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            comm = zmpi.Communicator(name="pmpi_us")
            small = [torch.ones(1024, device=TOOLS_DEVICE) for _ in range(4)]
            for turn in range(TOOLS_PMPI_TURNS):
                for attached in ((False, True) if turn % 2 == 0 else (True, False)):
                    if attached:
                        pmpi.attach(passthrough)
                    try:
                        got["attached" if attached else "none"].append(host_us_per_call(
                            torch, lambda i: comm.allreduce(small[i]), 4))
                    finally:
                        if attached:
                            pmpi.detach(passthrough)
        finally:
            dist.destroy_process_group()
    return {k: {"turns": v, "median": sorted(v)[len(v) // 2]} for k, v in got.items()}


def drive_tools(torch, np, tfm, card_line) -> dict:
    """Phase 22: the port's tools around the flagship forward (see the
    module doc).  Fails unless every gate holds."""
    import glob
    import io
    import shutil
    import threading

    import torch.distributed as dist
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.pt2pt import sm
    from zhpe_ompi_tpu_torch.runtime import dvm as dvm_mod
    from zhpe_ompi_tpu_torch.tools import info, mpirun, mpit, pmpi, ztrace, ztune

    t_phase = time.perf_counter()
    smoke = os.path.abspath(__file__)
    work = tempfile.mkdtemp(prefix="zmpi-tools-")
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    report: dict = {"ranks": TOOLS_RANKS}
    d = dvm_mod.Dvm()
    pmix_addr = ("127.0.0.1", d.pmix.address[1])
    try:
        # 1. ztune: sweep, distill, check, publish into the daemon's store
        t = time.perf_counter()
        cells = [c for size in TOOLS_SWEEP_SIZES for c in ztune.sweep(
            topos=("flat",), ops=TOOLS_SWEEP_OPS, min_bytes=size, max_bytes=size,
            iters=1, trials=1)]
        report["sweep_s"] = time.perf_counter() - t
        report["sweep_cells"] = len(cells)
        distilled = ztune.distill(cells)
        table = ztune.format_table(
            distilled, {k: ztune.geometry_for(cells, k) for k in distilled},
            note="chip_smoke phase 22")
        table_path = os.path.join(work, "tuned.table")
        with open(table_path, "w") as fh:
            fh.write(table)
        if len(cells) != len(TOOLS_SWEEP_SIZES) * len(TOOLS_SWEEP_OPS) \
                or ztune.check_table(table_path) != 0:
            raise SystemExit(f"tools: ztune swept {len(cells)} cells; table:\n{table}")
        report["table_rules"] = [list(rule) for v in distilled.values()
                                 for rule in v["rules"]]
        ztune.publish(f"{pmix_addr[0]}:{pmix_addr[1]}", table)

        # 2. the traced job
        out, err, res = io.StringIO(), io.StringIO(), {}

        def run():
            try:
                res["rc"] = mpirun.launch_dvm(
                    d.address, TOOLS_RANKS, [smoke, "--tools-child", "traced", work],
                    mca=TOOLS_MCA, metrics=True, trace=True, stdout=out, stderr=err,
                    timeout=TOOLS_WAIT_S)
            except Exception as e:  # noqa: BLE001 - reported below
                res["error"] = f"{type(e).__name__}: {e}"

        th = threading.Thread(target=run, daemon=True)
        th.start()
        launch = (th, out, err)
        try:
            _tools_wait(os.path.join(work, "ready"), launch, "rank 0's handshake")
            with open(os.path.join(work, "ready")) as fh:
                job = fh.read()
            remote = mpit.PvarSession(remote=(d.address, job, 0))
            handle = remote.handle_alloc("spc_tcp_bytes_sent")
            t = time.perf_counter()
            handle.start()
            read_ms = [(time.perf_counter() - t) * 1e3]
            _tools_touch(os.path.join(work, "go"))
            rise, deadline = 0, time.monotonic() + 60.0
            while rise <= 0:
                if time.monotonic() > deadline:
                    raise SystemExit("tools: rank 0's remote tcp_bytes_sent never rose")
                time.sleep(0.1)
                t = time.perf_counter()
                rise = handle.read()
                read_ms.append((time.perf_counter() - t) * 1e3)
            remote.free()
            report["remote_tcp_bytes_rise"] = rise
            report["remote_read_ms"] = read_ms
            for r in range(TOOLS_RANKS):
                _tools_wait(os.path.join(work, f"finished_{r}"), launch, f"rank {r}")
            # one periodic publish after the ranks' last spans
            time.sleep(0.6)
            snaps = d.store.lookup(job, "metrics:")
            pvars = {k: len(v["pvars"]) for k, v in snaps.items()}
            if len(snaps) != TOOLS_RANKS or not all(pvars.values()):
                raise SystemExit(f"tools: metrics snapshots' pvars {pvars}")
            report["snapshot_pvars"] = pvars
            t = time.perf_counter()
            payloads, offsets = ztrace.collect(pmix_addr, job)
            spans = ztrace.corrected_spans(payloads, offsets)
            report["merge_ms"] = (time.perf_counter() - t) * 1e3
            report["trace_spans"] = len(spans)
            report["clock_offsets"] = offsets
            violations = ztrace.happens_before_violations(spans)
            doc = ztrace.chrome_trace(payloads, offsets)
            trace_path = os.path.join(work, "tools_trace.json")
            with open(trace_path, "w") as fh:
                json.dump(doc, fh)
            report["chrome_trace_bytes"] = os.path.getsize(trace_path)
            tids = sorted({e["tid"] for e in doc["traceEvents"] if e["ph"] == "M"})
            text = ztrace.critical_path_report(payloads, offsets)
            insts = ztrace._coll_instances(spans)
            report["collective_instances"] = len(insts)
            report["stragglers"] = [[i["op"], i["straggler"]] for i in insts]
            if len(payloads) != TOOLS_RANKS or violations or offsets is None \
                    or tids != list(range(TOOLS_RANKS)) \
                    or len(insts) != 2 * TOOLS_FORWARDS \
                    or any(len(i["ranks"]) != TOOLS_RANKS for i in insts) \
                    or text.count("straggler rank") != len(insts):
                raise SystemExit(f"tools: trace of {len(payloads)} ranks, offsets "
                                 f"{offsets}, tids {tids}, {len(insts)} collective "
                                 f"instances, violations {violations[:5]}\n{text}")
        finally:
            _tools_touch(os.path.join(work, "release"))
            th.join(TOOLS_WAIT_S)
        if th.is_alive() or res.get("rc") != 0:
            raise SystemExit(f"tools: traced job {res}\n{out.getvalue()[-3000:]}\n"
                             f"{_rank_tails(err.getvalue(), 40)}")
    finally:
        d.stop()
    ranks = sorted(_child_json(out.getvalue(), "TOOLS"), key=lambda x: x["rank"])
    want_l = {"ln_fwd": 2 * cfg.n_layers + 1, "flash_fwd": cfg.n_layers} \
        if TOOLS_DEVICE == "cuda" else {}
    for x in ranks:
        if x["calls_by_op"] != x["want_calls"] \
                or x["pvar_allreduce_calls"] != x["calls_by_op"].get("allreduce") \
                or x["tcp_posted_recvs"] != 0 or x["tuned_table_store_fetches"] < 1 \
                or any(lc != want_l for lc in x["launches"]):
            raise SystemExit(f"tools: rank {x['rank']}: interceptor {x['calls_by_op']} "
                             f"(want {x['want_calls']}), mpit allreduce calls "
                             f"{x['pvar_allreduce_calls']}, posted "
                             f"{x['tcp_posted_recvs']}, store fetches "
                             f"{x['tuned_table_store_fetches']}, launches "
                             f"{x['launches']} (want {want_l} each)")
    if len(ranks) != TOOLS_RANKS:
        raise SystemExit(f"tools: {len(ranks)} TOOLS lines")
    # rank 0's gathered CE against this process's forward of all rows
    tok, tgt = (torch.from_numpy(a).to(TOOLS_DEVICE) for a in _tools_tokens(np, cfg))
    params = tfm.params_from_numpy(numpy_params(cfg, TOOLS_SEED), cfg, device=TOOLS_DEVICE)
    with torch.no_grad():
        ref = _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg).double().cpu().numpy()
    del params
    got = np.asarray(ranks[0]["row_ce"])
    mean_err = abs(float(got.mean()) - float(ref.mean()))
    row_err = float(np.abs(got - ref).max())
    total_err = max(abs(t - float(got.sum())) for t in ranks[0]["total_ce"])
    if not np.isfinite(got).all() or mean_err > TOOLS_CE_TOL or row_err > TOOLS_CE_TOL \
            or total_err > 1e-9 * abs(float(got.sum())):
        raise SystemExit(f"tools: the gathered CE differs by {mean_err} (mean), "
                         f"{row_err} (row), the allreduced total by {total_err}")

    # 3. the plain launcher, the checkpoint and info CLIs beside it
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(smoke)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    ckdir = os.path.join(work, "ckpt")
    clis = {name: subprocess.Popen(
        [sys.executable, "-m", f"zhpe_ompi_tpu_torch.tools.{mod}", *argv], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (mod, argv) in {"list": ("checkpoint", ["list", ckdir]),
                                  "inspect": ("checkpoint", ["inspect", ckdir]),
                                  "info": ("info", ["--json"])}.items()}
    plain: dict = {}
    threads = [threading.Thread(target=lambda k=k, m=m: plain.update(
        {k: _tools_plain(mpirun, k, m)}), daemon=True)
        for k, m in (("names", TOOLS_NAMES_MCA), ("abort", None))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TOOLS_WAIT_S)
    cli_out = {k: p.communicate(timeout=TOOLS_WAIT_S) + (p.returncode,)
               for k, p in clis.items()}
    names = sorted(_child_json(plain["names"]["out"], "NAMES"), key=lambda x: x["rank"])
    if plain["names"]["rc"] != 0 or len(names) != TOOLS_RANKS \
            or any(x["eager"] != 8192 or x["sum"] != 10 for x in names) \
            or names[0].get("hello") != f"hello from rank {TOOLS_RANKS - 1}" \
            or not names[-1].get("looked_up"):
        raise SystemExit(f"tools: names launch {plain['names']['rc']} {names}\n"
                         f"{plain['names']['err'][-3000:]}")
    aborted = _child_json(plain["abort"]["out"], "ABORT")
    left = [] if not aborted else glob.glob(os.path.join(
        sm.segment_dir(), f"zompi_pyring_{aborted[0]['session']}_*"))
    abort_ms = None if not aborted else \
        (plain["abort"]["t_return"] - aborted[0]["t_exit"]) * 1e3
    if plain["abort"]["rc"] != 3 or len(aborted) != 1 or not aborted[0]["sm"] \
            or aborted[0]["ring_files"] < 1 or left or abort_ms > TOOLS_ABORT_S * 1e3:
        raise SystemExit(f"tools: abort launch rc {plain['abort']['rc']}, {aborted}, "
                         f"{abort_ms} ms, ring files left {left}\n"
                         f"{plain['abort']['err'][-3000:]}")

    # 4. checkpoint and info
    for k, (o, e, rc) in cli_out.items():
        if rc != 0:
            raise SystemExit(f"tools: {k} CLI exited {rc}\n{o[-2000:]}\n{e[-2000:]}")
    leaves = sorted(line.split(": ", 1)[1] for line in cli_out["inspect"][0].splitlines()
                    if "leaf[" in line)
    want_leaves = sorted(f"shape={tuple(s)} dtype=float32"
                         for s in _serve_param_shapes(cfg).values())
    if leaves != want_leaves or "latest: 2" not in cli_out["list"][0]:
        raise SystemExit(f"tools: checkpoint list/inspect\n{cli_out['list'][0]}\n"
                         f"{cli_out['inspect'][0]}")
    pruned = subprocess.run([sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.checkpoint",
                             "prune", ckdir, "--keep", "1"], env=env, capture_output=True,
                            text=True, timeout=TOOLS_WAIT_S)
    if pruned.returncode != 0 or "pruned step 1" not in pruned.stdout \
            or sorted(n for n in os.listdir(ckdir) if n.startswith("step_")) != ["step_2"]:
        raise SystemExit(f"tools: prune\n{pruned.stdout}\n{pruned.stderr}")
    info_json = json.loads(cli_out["info"][0])
    comps = {f["framework"]: [c["name"] for c in f["components"]]
             for f in info_json["frameworks"]}
    in_process = info.gather()
    if "nccl" not in comps.get("coll", []) \
            or len(in_process["pvars"]) != mpit.pvar_get_num():
        raise SystemExit(f"tools: info lists coll {comps.get('coll')}; "
                         f"{len(in_process['pvars'])} pvars against "
                         f"{mpit.pvar_get_num()}")

    # 5. the PMPI seam's host cost
    pmpi_us = _tools_pmpi_host_us(torch, dist, zmpi, pmpi)
    shutil.rmtree(work)
    report.update({
        "forward_ms": [x["forward_ms"] for x in ranks],
        "launches": [x["launches"] for x in ranks],
        "launches_per_forward": ranks[0]["launches"][0],
        "interceptor_calls": ranks[0]["calls_by_op"],
        "interceptor_us": [x["interceptor_us"] for x in ranks],
        "pvar_allreduce_calls": [x["pvar_allreduce_calls"] for x in ranks],
        "tuned_table_store_fetches": [x["tuned_table_store_fetches"] for x in ranks],
        "checkpoint_ms": ranks[0]["checkpoint_ms"],
        "ce_mean_abs_err": mean_err, "ce_row_max_abs_err": row_err,
        "ce_tol": TOOLS_CE_TOL,
        "spawn_to_first_line_ms": {k: v["first_line_ms"] for k, v in plain.items()},
        "abort_to_rc_ms": abort_ms, "abort_ring_files": aborted[0]["ring_files"],
        "info_pvars": len(info_json["pvars"]), "info_coll": comps["coll"],
        "pmpi_host_us": pmpi_us,
        "pmpi_overhead_us": pmpi_us["attached"]["median"] - pmpi_us["none"]["median"],
        "phase_s": time.perf_counter() - t_phase})
    print(json.dumps({"tools": report, "card": card_line}))
    print(f"tools ({TOOLS_RANKS} daemon-hosted ranks, flagship width): sweep "
          f"{report['sweep_cells']} cells in {report['sweep_s']} s; forward ms "
          f"{report['forward_ms']}; launches {report['launches_per_forward']}; "
          f"interceptor {report['interceptor_calls']}; remote pvar reads "
          f"{report['remote_read_ms']} ms; {report['trace_spans']} spans merged in "
          f"{report['merge_ms']} ms; spawn-to-first-line "
          f"{report['spawn_to_first_line_ms']} ms; abort-to-rc {abort_ms} ms; "
          f"PMPI host µs none {pmpi_us['none']['median']} attached "
          f"{pmpi_us['attached']['median']}; phase {report['phase_s']} s on {card_line}")
    return report


def _native_tokens(np, cfg):
    """Phase 23's batch: (tokens, targets) of NATIVE_BATCH rows, one seed."""
    rng = np.random.default_rng(NATIVE_SEED + 1)
    return tuple(rng.integers(0, cfg.vocab, (NATIVE_BATCH, cfg.seq), dtype=np.int64)
                 for _ in range(2))


def _best_s(fn, turns=NATIVE_TURNS):
    """The least wall seconds of ``turns`` calls of ``fn`` (after one
    uncounted call), and the last call's result."""
    out = fn()
    best = math.inf
    for _ in range(turns):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return best, out


def _native_pingpong(torch, native_on):
    """One-way µs (half a round trip) of two ``TcpProc`` ranks in threads
    (TCP alone) at each NATIVE_PINGPONG size, with the native matching
    engine or (``native_on`` False: the switch set while the ranks are
    made) the Python one."""
    import socket

    from zhpe_ompi_tpu_torch import native
    from zhpe_ompi_tpu_torch.pt2pt import matching
    from zhpe_ompi_tpu_torch.pt2pt.tcp import TcpProc

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    held = os.environ.get("ZOMPI_NATIVE")
    if not native_on:
        os.environ["ZOMPI_NATIVE"] = "0"
    native.reset()
    procs = [None, None]
    try:
        def make(r):
            procs[r] = TcpProc(r, 2, coordinator=("127.0.0.1", port), sm=False)

        _in_threads(2, make, HOST_TIMEOUT_S)
    finally:
        if held is None:
            os.environ.pop("ZOMPI_NATIVE", None)
        else:
            os.environ["ZOMPI_NATIVE"] = held
        native.reset()
    want = matching.NativeMatchingEngine if native_on else matching.MatchingEngine
    engines = [type(p.engine).__name__ for p in procs]
    if any(type(p.engine) is not want for p in procs):
        raise SystemExit(f"native: pingpong engines {engines}, want {want.__name__}")
    out = {}
    try:
        for nbytes, trips in NATIVE_PINGPONG:
            msg = torch.zeros(nbytes, dtype=torch.uint8)
            secs = [0.0]

            def rank(r):
                p = procs[r]
                for i in range(trips + 20):
                    if i == 20:
                        t = time.perf_counter()
                    if r == 0:
                        p.send(msg, dest=1, tag=5)
                        p.recv(source=1, tag=5)
                    else:
                        p.send(p.recv(source=0, tag=5), dest=0, tag=5)
                if r == 0:
                    secs[0] = time.perf_counter() - t

            _in_threads(2, rank, HOST_TIMEOUT_S)
            out[str(nbytes)] = secs[0] / trips / 2 * 1e6
    finally:
        for p in procs:
            p.close()
    return {"engine": engines[0], "one_way_us": out}


def _native_pack(np):
    """The strided pack of a vector datatype over NATIVE_PACK_BYTES of
    float32 (64 blocks of 16 floats every 32 a datatype element, resized
    to 8 KiB, so NATIVE_PACK_BYTES / 8 KiB elements): the native segment
    walk against the index-map gather the switches select (its map made
    once and cached, as the convertor does), GB/s of packed bytes; both
    must give the same bytes."""
    from zhpe_ompi_tpu_torch.datatype import convertor, derived, predefined

    dt = derived.create_resized(derived.create_vector(64, 16, 32, predefined.FLOAT),
                                0, 8192)
    count = NATIVE_PACK_BYTES // 8192
    src = np.random.default_rng(NATIVE_SEED).integers(
        0, 256, convertor.span_bytes(dt, count), dtype=np.uint8)
    t_native, packed = _best_s(lambda: convertor.pack(src, dt, count))
    t_index, gathered = _best_s(lambda: src[convertor.byte_index_map(dt, count)])
    if not np.array_equal(packed, gathered):
        raise SystemExit("native: the native pack and the index map differ")
    return {"packed_bytes": int(packed.nbytes), "source_bytes": int(src.nbytes),
            "native_gb_s": packed.nbytes / t_native / 1e9,
            "index_map_gb_s": packed.nbytes / t_index / 1e9,
            "native_ms": t_native * 1e3, "index_map_ms": t_index * 1e3}


def _native_reduce(torch):
    """SUM of NATIVE_REDUCE_ELEMS host float32: ``zompi_reduce`` (the
    ``Op``'s native path) against the torch combine; equal bits."""
    from zhpe_ompi_tpu_torch import native, ops

    g = torch.Generator().manual_seed(NATIVE_SEED)
    a, b = (torch.randn(NATIVE_REDUCE_ELEMS, generator=g) for _ in range(2))
    calls = []
    lib = native.load()

    class Counted:
        def __getattr__(self, name):
            return getattr(lib, name)

        def zompi_reduce(self, *args):
            calls.append(args[:2])
            return lib.zompi_reduce(*args)

    native.lib = Counted()
    try:
        t_native, got = _best_s(lambda: ops.SUM(a, b))
    finally:
        native.lib = lib
    t_torch, want = _best_s(lambda: ops.SUM._fn(a, b))
    if len(calls) != NATIVE_TURNS + 1 or not torch.equal(got, want):
        raise SystemExit(f"native: zompi_reduce calls {calls[:3]}, "
                         f"equal {torch.equal(got, want)}")
    moved = 3 * a.numel() * a.element_size()
    return {"elems": a.numel(), "native_ms": t_native * 1e3,
            "torch_ms": t_torch * 1e3, "native_gb_s": moved / t_native / 1e9,
            "torch_gb_s": moved / t_torch / 1e9,
            "torch_threads": torch.get_num_threads()}


def native_child() -> int:
    """Phase 23's port rank (see the module doc): rows from the C rank's
    Scatterv, the flagship forward on the card, the rows' CE through its
    Gatherv and the mean from its Bcast; rank 1 also sends the rows and
    times the host paths.  Prints one ``NATIVE {json}`` line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.native.cwire import CWorld

    sync = torch.cuda.synchronize if NATIVE_DEVICE == "cuda" else (lambda: None)
    ep = zmpi.host_init(timeout=HOST_TIMEOUT_S)
    r = ep.rank
    cw = CWorld(ep)
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    out: dict = {"rank": r, "size": ep.size, "sm": ep._sm_seg is not None,
                 "engine": type(ep.engine).__name__}
    if r == 1:
        ep.send(np.concatenate(_native_tokens(np, cfg), axis=1), dest=0, tag=23)
    rows = cw.scatterv(0, timeout=HOST_TIMEOUT_S)
    out["rows_type"] = f"{type(rows).__name__} {rows.dtype} {rows.device}"
    rows = rows.reshape(NATIVE_ROWS, 2 * cfg.seq)
    tok, tgt = (x.contiguous().to(NATIVE_DEVICE) for x in rows.split(cfg.seq, 1))
    params = tfm.params_from_numpy(numpy_params(cfg, NATIVE_SEED), cfg,
                                   device=NATIVE_DEVICE)
    with torch.no_grad():
        _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg)  # set-up
    sync()
    before = _build.thread_launches()
    t = time.perf_counter()
    with torch.no_grad():
        row_ce = _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg)
    sync()
    out["forward_ms"] = (time.perf_counter() - t) * 1e3
    after = _build.thread_launches()
    out["launches"] = {k: v - before.get(k, 0) for k, v in after.items()
                       if v != before.get(k, 0)}
    out["row_ce"] = row_ce.float().cpu().tolist()
    cw.gatherv(row_ce.float().cpu(), 0)
    mean = cw.bcast(None, 0, timeout=HOST_TIMEOUT_S)
    out["mean_ce"] = float(mean.reshape(-1)[0])
    ep.barrier()  # the C rank's MPI_Barrier
    del params
    if r == 1:
        out["pingpong"] = {k: _native_pingpong(torch, k == "native")
                           for k in ("native", "python")}
        out["pack"] = _native_pack(np)
        out["reduce"] = _native_reduce(torch)
    zmpi.host_finalize()
    print("NATIVE " + json.dumps(out), flush=True)
    return 0


def drive_native(torch, np, tfm, card_line, build_s) -> dict:
    """Phase 23: the native host kernels, the C ABI and ``zmpicc`` (see the
    module doc); ``build_s`` the libraries' build seconds.  Fails unless
    every gate holds."""
    import io
    import shutil

    import torch.nn.functional as F

    from zhpe_ompi_tpu_torch.bench import numpy_params
    from zhpe_ompi_tpu_torch.tools import mpirun

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    smoke = os.path.abspath(__file__)
    work = tempfile.mkdtemp(prefix="zmpi-native-")
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    feed = os.path.join(work, "feed_c")
    t = time.perf_counter()
    cc = subprocess.run(
        [sys.executable, "-m", "zhpe_ompi_tpu_torch.tools.zmpicc",
         os.path.join(here, "zhpe_ompi_tpu_torch", "native", "feed_c.c"), "-o", feed],
        env=env, capture_output=True, text=True, timeout=NATIVE_TIMEOUT_S)
    zmpicc_s = time.perf_counter() - t
    if cc.returncode != 0:
        raise SystemExit(f"native: zmpicc feed_c.c rc {cc.returncode}:\n{cc.stderr}")
    out, err = io.StringIO(), io.StringIO()
    t = time.perf_counter()
    rc = mpirun.launch_mpmd(
        [(1, [feed, str(NATIVE_BATCH), str(2 * cfg.seq)]),
         (NATIVE_RANKS, [smoke, "--native-child"])],
        timeout=NATIVE_TIMEOUT_S, stdout=out, stderr=err)
    job_s = time.perf_counter() - t
    if rc != 0:
        raise SystemExit(f"native: MPMD job rc {rc}\n{out.getvalue()[-3000:]}\n"
                         f"{_rank_tails(err.getvalue(), 40)}")
    shutil.rmtree(work)
    feeds = _child_json(out.getvalue(), "FEED")
    ranks = sorted(_child_json(out.getvalue(), "NATIVE"), key=lambda x: x["rank"])
    if len(feeds) != 1 or [x["rank"] for x in ranks] != list(range(1, NATIVE_RANKS + 1)):
        raise SystemExit(f"native: {len(feeds)} FEED lines, NATIVE ranks "
                         f"{[x['rank'] for x in ranks]}\n{out.getvalue()[-3000:]}")
    fed = feeds[0]
    want_l = {"ln_fwd": 2 * cfg.n_layers + 1, "flash_fwd": cfg.n_layers} \
        if NATIVE_DEVICE == "cuda" else {}
    for x in ranks:
        mine = fed["row_ce"][(x["rank"] - 1) * NATIVE_ROWS:x["rank"] * NATIVE_ROWS]
        if x["launches"] != want_l or x["mean_ce"] != fed["mean_ce"] \
                or max(abs(a - b) for a, b in zip(mine, x["row_ce"])) > 1e-6 \
                or x["engine"] != "NativeMatchingEngine" \
                or not x["rows_type"].startswith("Tensor torch.int64 cpu"):
            raise SystemExit(f"native: rank {x['rank']}: launches {x['launches']} "
                             f"(want {want_l}), mean {x['mean_ce']} vs the C rank's "
                             f"{fed['mean_ce']}, rows {x['row_ce']} vs {mine}, engine "
                             f"{x['engine']}, rows {x['rows_type']}")
    # the C rank's mean and rows against this process's forward of all rows
    tok, tgt = (torch.from_numpy(a).to(NATIVE_DEVICE) for a in _native_tokens(np, cfg))
    params = tfm.params_from_numpy(numpy_params(cfg, NATIVE_SEED), cfg,
                                   device=NATIVE_DEVICE)
    with torch.no_grad():
        ref = _tools_row_ce(torch, F, tfm, params, tok, tgt, cfg).double().cpu().numpy()
    del params
    got = np.asarray(fed["row_ce"])
    mean_err = abs(fed["mean_ce"] - float(ref.mean()))
    row_err = float(np.abs(got - ref).max())
    if fed["size"] != NATIVE_RANKS + 1 or len(got) != NATIVE_BATCH \
            or not np.isfinite(got).all() or mean_err > NATIVE_CE_TOL \
            or row_err > NATIVE_CE_TOL:
        raise SystemExit(f"native: the C rank's mean CE {fed['mean_ce']} differs by "
                         f"{mean_err} (row {row_err}) from this process's "
                         f"{float(ref.mean())} (tolerance {NATIVE_CE_TOL})")
    host = ranks[0]
    report = {
        "ranks": {"c": 1, "port": NATIVE_RANKS}, "build_s": build_s,
        "zmpicc_s": zmpicc_s, "job_s": job_s, "mean_ce": fed["mean_ce"],
        "ref_mean_ce": float(ref.mean()), "ce_mean_abs_err": mean_err,
        "ce_row_max_abs_err": row_err, "ce_tol": NATIVE_CE_TOL,
        "forward_ms": [x["forward_ms"] for x in ranks],
        "launches": [x["launches"] for x in ranks],
        "launches_per_forward": ranks[0]["launches"],
        "sm": [x["sm"] for x in ranks],
        "pingpong_one_way_us": {k: v["one_way_us"] for k, v in host["pingpong"].items()},
        "pack": host["pack"], "reduce": host["reduce"],
        "phase_s": time.perf_counter() - t_phase}
    print(json.dumps({"native": report, "card": card_line}))
    pp = report["pingpong_one_way_us"]
    print(f"native (1 C rank + {NATIVE_RANKS} port ranks, flagship width): mean CE "
          f"{fed['mean_ce']} vs {report['ref_mean_ce']} (err {mean_err}); forward ms "
          f"{report['forward_ms']}; launches {report['launches_per_forward']}; "
          f"pingpong one-way µs native {pp['native']} python {pp['python']}; pack GB/s "
          f"native {host['pack']['native_gb_s']} index map "
          f"{host['pack']['index_map_gb_s']}; SUM 16 Mi f32 ms native "
          f"{host['reduce']['native_ms']} torch {host['reduce']['torch_ms']}; build s "
          f"{build_s}; phase {report['phase_s']} s on {card_line}")
    return report


def start_native_build():
    """Build the native kernel library and the C ABI shim with ``g++`` in a
    thread (beside the CUDA kernels' ``nvcc``); the returned function joins
    it and gives each library's build seconds, or raises its failure."""
    import threading

    from zhpe_ompi_tpu_torch import native

    box: dict = {}

    def run():
        try:
            native.build()
            native.build_mpi_shim()
        except BaseException as e:  # noqa: BLE001 - raised by the join
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join() -> dict:
        th.join()
        if "error" in box:
            raise SystemExit(f"native build failed: {box['error']}")
        # g++'s seconds; 0.0 for a library found already built
        return {k: native.build_seconds.get(k, 0.0) for k in ("zompi", "zompi_mpi")}

    return join


def drive_runtime(torch, np, dist, tfm, fused_norm, fa, card_line):
    """Phase 5: the MPI entry point, the monitored train step, the ULFM
    methods on CUDA tensors, the device probe, the bench, finalize."""
    import contextlib
    import io

    from zhpe_ompi_tpu_torch import bench
    from zhpe_ompi_tpu_torch.comm.communicator import Communicator
    from zhpe_ompi_tpu_torch.core import errhandler as errh
    from zhpe_ompi_tpu_torch.core import errors
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.parallel import mesh as mesh_mod
    from zhpe_ompi_tpu_torch.runtime import init as rt
    from zhpe_ompi_tpu_torch.runtime import spc

    if dist.is_initialized():
        raise SystemExit("runtime phase: a process group is already up")
    mca_var.set_var("hook_comm_method_enable", True)
    mca_var.set_var("coll_monitoring_enable", True)
    hook_err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(hook_err):
        world = rt.init()
    init_ms = (time.perf_counter() - t0) * 1e3
    hook_lines = [ln for ln in hook_err.getvalue().splitlines() if "comm_method" in ln]
    for ln in hook_lines:
        print(f"hook: {ln}")
    cs = rt.comm_self()
    print(f"runtime.init(): {init_ms} ms; world {world.name} rank {world.rank} of "
          f"{world.size} on {world.backend}, self {cs.name} size {cs.size} on "
          f"{cs.backend}; {card_line}")
    if not (world.size == 1 and world.backend == "nccl" and cs.size == 1
            and cs.backend == "nccl" and dist.is_initialized()):
        raise SystemExit("runtime.init() did not make a one-rank NCCL world")
    want_hook = "comm_method: world of 1 rank(s) [0] on cuda device(s), backend nccl"
    if not (hook_lines and want_hook in hook_lines[0]
            and sum("-> tuned" in ln for ln in hook_lines) == 12):
        raise SystemExit("the comm_method hook did not print the world's layout")

    mesh = mesh_mod.make_mesh({"dp": 1, "tp": 1, "sp": 1})
    dp_comm = Communicator(mesh.get_group("dp"), name="dp")
    tp_comm = world.split([0], name="tp")
    sp_comm = Communicator(mesh.get_group("sp"), name="sp_mesh").dup(name="sp")
    one = torch.ones(4, device="cuda")
    for comm in (dp_comm, tp_comm, sp_comm):
        if comm.allreduce(one).tolist() != [1.0] * 4 or comm.backend != "nccl":
            raise SystemExit(f"{comm.name}: a one-rank NCCL allreduce went wrong")

    # the monitored train step
    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    step, _ = tfm.make_train_step(cfg, dp_comm, tp_comm, lr=TRAIN_LR)
    params, tokens, targets = _train_inputs(torch, np, tfm, cfg)
    L = cfg.n_layers
    n_dp = len(params) + 1                                   # grads, loss
    n_tp = len(tfm._TP_REPLICATED & set(params)) + 1 + 4 * L  # + f/g pair
    want_calls = {"coll_allreduce_calls": n_dp + n_tp,
                  "comm_dp_coll_calls": n_dp, "comm_tp_coll_calls": n_tp}
    counted = _kernel_counters(fused_norm, fa)
    want = _step_launches(cfg)
    losses = []
    for i in range(3):
        for fn in counted.values():
            fn.launches = 0
        before = spc.snapshot()
        params, loss = step(params, tokens, targets)
        loss = float(loss)
        after = spc.snapshot()
        launches = {name: fn.launches for name, fn in counted.items()}
        calls = {k: after.get(k, 0) - before.get(k, 0) for k in want_calls}
        print(f"runtime step {i}: loss {loss}, launches {launches} (expected "
              f"{want}), allreduce calls {calls} (expected {want_calls})")
        if launches != want:
            raise SystemExit("the monitored step did not launch the kernels as expected")
        if calls != want_calls:
            raise SystemExit("coll_allreduce_calls did not rise by the step's "
                             "Communicator.allreduce calls")
        losses.append(loss)
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise SystemExit(f"runtime: the loss did not fall with finite values: {losses}")
    del params
    mca_var.unset("coll_monitoring_enable")

    # ULFM on CUDA tensors
    rv = world.dup(name="rv")
    rv.set_errhandler(errh.ERRORS_RETURN)
    rv.allreduce(one)
    rv.revoke()
    try:
        rv.allreduce(one)
        raise SystemExit("an allreduce on a revoked communicator did not raise")
    except errors.Revoked as e:
        print(f"revoked: allreduce raised Revoked ({e})")
    shrunk = rv.shrink(failed=[])
    got = shrunk.allreduce(torch.full((4,), 2.0, device="cuda")).tolist()
    agreed = (rv.agree(True), shrunk.agree(True), shrunk.agree(False))
    print(f"shrink(failed=[]): allreduce {got}, revoked {shrunk.is_revoked()}; "
          f"agree True/True/False on revoked/shrunk/shrunk: {agreed}")
    if got != [2.0] * 4 or shrunk.is_revoked() or agreed != (True, True, False):
        raise SystemExit("shrink or agree went wrong on CUDA tensors")

    # the device probe
    probes = {}
    t0 = time.perf_counter()
    kind, detail = mesh_mod.probe_device_plane()
    probes["ok"] = (kind, detail, time.perf_counter() - t0)
    for wedge in ("all", str(world.rank)):
        t0 = time.perf_counter()
        env = dict(os.environ, ZMPI_DEVICE_WEDGE=wedge)
        kind, detail = mesh_mod.probe_device_plane(timeout=30, deadline=12, env=env,
                                                   rank=world.rank)
        probes[f"wedge={wedge}"] = (kind, detail, time.perf_counter() - t0)
    print(json.dumps({"device_probe": probes, "card": card_line}))
    if probes["ok"][0] != "ok":
        raise SystemExit(f"probe_device_plane() did not answer: {probes['ok']}")
    print(f"device probe: ok in {probes['ok'][2]} s; the child's seconds by stage "
          f"{json.loads(probes['ok'][1])['seconds']}")
    for key, (kind, _, secs) in probes.items():
        if key != "ok" and (kind not in ("deadline", "hung") or secs > 35):
            raise SystemExit(f"the wedged probe ({key}) was not caught: {kind}")

    # the bench, on fresh communicators with monitoring off
    b_dp, b_tp = bench.mesh_comms()
    name = bench.card_name(torch.cuda.current_device())
    peak, known = bench.card_peak(name)
    t0 = time.perf_counter()
    result = bench.run(b_dp, b_tp, peak, known)
    result["card"] = card_line
    result["bench_s"] = time.perf_counter() - t0
    print(json.dumps({"bench": result}))
    for r in (result, result["remat_off"]):
        print(f"bench remat={r is result}: framework {r['step_ms']} ms "
              f"({r['value']} tokens/s), plain {r['plain_step_ms']} ms "
              f"({r['plain_tokens_per_s']} tokens/s), vs_baseline "
              f"{r['vs_baseline']}, mfu {r['mfu']} on {card_line}")
        if not (math.isfinite(r["vs_baseline"]) and 0 < r["mfu"] < 1 and known):
            raise SystemExit("the bench's measurement is not sane")
    # one long-context step (the bench's configuration) between counts
    lc_cfg = tfm.Config(**{**HEADLINE, "seq": bench.LONG_CONTEXT["seq"]},
                        dtype=torch.bfloat16, ce_chunk=CE_CHUNK, remat=True)
    lc_step, _ = tfm.make_train_step(lc_cfg, b_dp, b_tp, lr=bench.LR)
    lc_params, lc_tok, lc_tgt = _train_inputs(torch, np, tfm, lc_cfg,
                                              batch=bench.LONG_CONTEXT["batch"])
    for fn in counted.values():
        fn.launches = 0
    _, lc_loss = lc_step(lc_params, lc_tok, lc_tgt)
    lc_loss = float(lc_loss)
    lc_launches = {name: fn.launches for name, fn in counted.items()}
    lc_want = {"layernorm_fwd": 4 * L + 1, "layernorm_bwd": 2 * L + 1,
               "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
               "flash_attention_bwd_dkv": L}
    print(f"long-context step (seq {lc_cfg.seq}, batch {bench.LONG_CONTEXT['batch']}, "
          f"remat): loss {lc_loss}, launches {lc_launches} (expected {lc_want})")
    if lc_launches != lc_want or not math.isfinite(lc_loss):
        raise SystemExit("the long-context step did not launch the kernels as expected")
    del lc_params
    print(f"bench long context: seq {result['long_ctx_seq']}, "
          f"{result['long_ctx_step_ms']} ms, {result['long_ctx_tokens_per_s']} "
          f"tokens/s, mfu {result['long_ctx_mfu']} on {card_line}")

    fin_err = io.StringIO()
    with contextlib.redirect_stderr(fin_err):
        rt.finalize()
    for ln in fin_err.getvalue().splitlines():
        if "comm_method" in ln:
            print(f"hook: {ln}")
    mca_var.unset("hook_comm_method_enable")
    if dist.is_initialized() or not rt.is_finalized():
        raise SystemExit("finalize() left the process group up")
    return launches, lc_launches, {"init_ms": init_ms,
                                   "allreduce_calls_per_step": want_calls,
                                   "bench": result}


def bench_after_profiling(torch, tfm, dp_comm, tp_comm, runtime, card_line):
    """The bench's remat-off pair once more, in this process after the
    profiled phases, beside phase 5's reading taken before them: how much
    the process's history moves the host-bound step."""
    from zhpe_ompi_tpu_torch import bench

    cfg = tfm.Config(**HEADLINE, dtype=torch.bfloat16, ce_chunk=CE_CHUNK)
    peak, known = bench.card_peak(bench.card_name(torch.cuda.current_device()))
    late = bench.measure_pair(cfg, dp_comm, tp_comm, BATCH, peak, known)
    early = runtime["bench"]["remat_off"]
    print(f"bench remat off after the profiled phases: framework {late['step_ms']} ms, "
          f"plain {late['plain_step_ms']} ms, vs_baseline {late['vs_baseline']} "
          f"(before them: {early['step_ms']}, {early['plain_step_ms']}, "
          f"{early['vs_baseline']}) on {card_line}")
    return {k: late[k] for k in ("step_ms", "plain_step_ms", "vs_baseline",
                                 "pair_ratios")}


def check_ring_recurrence(torch, ra):
    """The ring's block recurrence at full width on the card: the sequence
    split into RING_BLOCKS blocks; for each virtual rank, the port's own
    step update (``_contiguous_step``) over the blocks in the order the
    ring delivers them (``_ring_sources``), then the normalisation,
    against ``_block_attention_single`` on the whole sequence; the same
    for the zigzag layout (``_zigzag_step``)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, S, h = BATCH, HEADLINE["seq"], HEADLINE["n_heads"]
    hd = HEADLINE["d_model"] // h
    n = RING_BLOCKS
    q, k, v = (torch.randn((B, S, h, hd), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    want = ra._block_attention_single(q, k, v, True)
    sl = S // n
    # the port's own per-step updates, in the order the ring delivers the
    # blocks (models/ring_attention.py)

    def contiguous(r):
        qf = q[:, r * sl:(r + 1) * sl].float() * hd ** -0.5
        state = ra._init(q, sl)
        for src in ra._ring_sources(r, n):
            state = ra._contiguous_step(qf, k[:, src * sl:(src + 1) * sl],
                                        v[:, src * sl:(src + 1) * sl], state, r, src,
                                        True)
        return ra._finish(*state[1:]).to(q.dtype)

    qz, kz, vz = (ra.zigzag_shard(t, n) for t in (q, k, v))
    c = sl // 2
    diag = torch.tril(torch.ones((c, c), dtype=torch.bool, device="cuda"))

    def zigzag(r):
        qf = qz[r].float() * hd ** -0.5
        sa, sb = ra._init(q, c), ra._init(q, c)
        for src in ra._ring_sources(r, n):
            sa, sb = ra._zigzag_step(qf[:, :c], qf[:, c:], kz[src], vz[src], sa, sb,
                                     r, src, diag)
        return torch.cat([ra._finish(*sa[1:]), ra._finish(*sb[1:])], 1).to(q.dtype)

    want_z = ra.zigzag_shard(want, n)
    result = {}
    for layout, fn, ref in (("contiguous", contiguous,
                             lambda r: want[:, r * sl:(r + 1) * sl]),
                            ("zigzag", zigzag, lambda r: want_z[r])):
        errs, ms = [], []
        for r in range(n):
            errs.append(_max_err(fn(r), ref(r)))
            ms.append(_event_ms(torch, lambda: fn(r)))
        print(f"ring recurrence {layout} at {(B, S, h, hd)} bf16 causal, {n} blocks: "
              f"max|ring - single| per rank {errs} (tol {RING_TOL}), "
              f"ms per rank (CUDA events, host issue included) {ms}")
        if not max(errs) <= RING_TOL:
            raise SystemExit(f"the {layout} ring recurrence disagrees with "
                             "_block_attention_single")
        result[layout] = {"max_abs_err": max(errs), "ms_per_rank": ms}
    return result


def _one_rank_answer(torch, opname, x):
    """What each collective gives at one rank, from its MPI definition (an
    exscan's rank 0 result, undefined in MPI, is zeros here)."""
    if opname == "barrier":
        return torch.zeros((), dtype=torch.int32, device=x.device)
    if opname == "exscan":
        return torch.zeros_like(x)
    if opname == "scatter":
        return x.reshape(-1)
    return x


def check_collectives(torch, comm, zmpi, tuned, nccl, mca_var):
    """Every entry of ``comm.coll``, and every algorithm of
    coll/algorithms.py forced through ZMPI_MCA_coll_tuned_<op>_algorithm,
    on a one-rank NCCL communicator with CUDA tensors of f32, bf16 and
    int32: each must give the one-rank MPI answer.  Then the host µs per
    call of ``comm.allreduce`` (tuned, then nccl) and of the nccl
    component's allreduce alone."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    base = torch.randn((4, 6), generator=gen, device="cuda")
    checked = 0

    def run(opname, x, dtype):
        nonlocal checked
        if opname in ("allreduce", "reduce", "reduce_scatter",
                      "reduce_scatter_block", "scan", "exscan"):
            outs = [getattr(comm, opname)(x, op) for op in (zmpi.SUM, zmpi.PROD,
                                                            zmpi.MAX)]
        elif opname == "barrier":
            outs = [comm.barrier()]
        elif opname == "alltoallv":
            outs = [comm.alltoallv(x[None], [[x.shape[0]]])[0]]
        elif opname == "allgatherv":
            outs = [comm.allgatherv(x, [x.shape[0]])]
        elif opname in ("bcast", "gather", "scatter"):
            outs = [getattr(comm, opname)(x, root=0)]
        else:
            outs = [getattr(comm, opname)(x)]
        want = _one_rank_answer(torch, opname, x)
        for got in outs:
            if not (got.device == x.device and got.shape == want.shape
                    and torch.equal(got, want)):
                raise SystemExit(f"{opname} on {dtype} at one rank gave {got}, "
                                 f"not {want}")
            checked += 1

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = (base * 4).to(dtype)
        for opname in comm.coll:
            run(opname, x, dtype)
        for opname, table in tuned._ALG_TABLES.items():
            var = f"coll_tuned_{opname}_algorithm"
            for algname in table:
                os.environ["ZMPI_MCA_" + var] = algname
                mca_var.unset(var)  # re-resolve the variable from the environment
                if mca_var.get(var) != algname:
                    raise SystemExit(f"{var} did not take {algname} from the environment")
                run(opname, x, dtype)
            del os.environ["ZMPI_MCA_" + var]
            mca_var.unset(var)
    print(f"collectives: {checked} one-rank results checked (every coll entry and "
          f"every forced algorithm, f32, bf16 and int32)")
    # tuned's own host cost: the same allreduce through ``comm`` and through
    # a communicator composed without tuned (nccl serves it straight, the
    # route before tuned existed), in turns, each side first in every
    # other round, so that both see the same host
    mca_var.set_var("coll", "^tuned")
    try:
        direct = comm.dup(name="direct")
        if direct.coll["allreduce"][1] != "nccl":
            raise SystemExit(f"excluding tuned left {direct.coll['allreduce'][1]}")
    finally:
        mca_var.unset("coll")
    small = [torch.ones(1024, device="cuda") for _ in range(4)]
    sides = {"comm.allreduce (tuned -> nccl)": comm, "comm.allreduce without tuned": direct}
    turns = {name: [] for name in sides}
    for i in range(HOST_US_TURNS):
        for name in (list(sides) if i % 2 == 0 else list(sides)[::-1]):
            c = sides[name]
            turns[name].append(host_us_per_call(torch, lambda j: c.allreduce(small[j]), 4))
    tuned_us, direct_us = turns.values()
    host = {name: _quartiles(us) for name, us in turns.items()}
    host["tuned_faster_in_turns"] = sum(a < b for a, b in zip(tuned_us, direct_us))
    host["turns"] = HOST_US_TURNS
    host["nccl.allreduce alone"] = host_us_per_call(
        torch, lambda i: nccl.allreduce(comm, small[i], zmpi.SUM), 4)
    print(json.dumps({"allreduce_host_us_per_call": host,
                      "card": torch.cuda.get_device_name(0)}))
    return checked, host


def comm_allreduce_host_us(torch, zmpi, dist):
    """Host µs per call of ``Communicator.allreduce`` of 1024 floats on a
    one-rank NCCL communicator of the port found on sys.path."""
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            comm = zmpi.Communicator(name="host_us")
            small = [torch.ones(1024, device="cuda") for _ in range(4)]
            return host_us_per_call(torch, lambda i: comm.allreduce(small[i]), 4)
        finally:
            dist.destroy_process_group()


def _quartiles(xs) -> dict:
    xs = sorted(xs)
    n = len(xs)
    return {"median": xs[n // 2], "q1": xs[n // 4], "q3": xs[(3 * n) // 4],
            "min": xs[0], "max": xs[-1], "n": n}


def compare_host_us(other_root: str, pairs: int) -> dict:
    """``--wrapper-host-us`` for ``other_root`` and for the port beside
    this script, in ``pairs`` alternating pairs of processes; each
    version's median and quartiles of every number."""
    here = os.path.dirname(os.path.abspath(__file__))
    roots = {"other": os.path.abspath(other_root), "this": here}
    readings = {"other": [], "this": []}
    for i in range(pairs):
        for which in (("other", "this") if i % 2 == 0 else ("this", "other")):
            run = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--wrapper-host-us",
                 roots[which]], capture_output=True, text=True, check=False)
            if run.returncode != 0:
                raise SystemExit(f"--wrapper-host-us {roots[which]} failed:\n"
                                 f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
            reading = json.loads(run.stdout.strip().splitlines()[-1])
            readings[which].append({"comm_allreduce": reading["comm_allreduce_host_us"],
                                    **reading["wrapper_host_us"]})
    this_faster = sum(t["comm_allreduce"] < o["comm_allreduce"]
                      for t, o in zip(readings["this"], readings["other"]))
    return ({which: {key: _quartiles([r[key] for r in rs]) for key in rs[0]}
             for which, rs in readings.items()}
            | {"comm_allreduce_this_faster_in_pairs": this_faster,
               "readings": readings, "roots": roots, "pairs": pairs})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    bench_after = args == ["--bench-after"]
    if bench_after:
        args = []
    if args and args[0] == "--compare-host-us" and len(args) in (2, 3):
        result = compare_host_us(args[1], int(args[2]) if len(args) == 3 else 10)
        print(json.dumps({"host_us_pairs": result, "card": _card_line()}))
        return 0
    if args == ["--host-moe-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return host_moe_child()
    if args == ["--ft-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return ft_child()
    if args == ["--hybrid-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return hybrid_child()
    if args == ["--osc-io-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return osc_io_child()
    if args and args[0] == "--tools-child" and len(args) in (2, 3) \
            and args[1] in ("traced", "names", "abort"):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return tools_child(args[1], args[2] if len(args) == 3 else None)
    if args == ["--native-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return native_child()
    if args == ["--native"]:
        # phase 23 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        from zhpe_ompi_tpu_torch import _build
        from zhpe_ompi_tpu_torch.models import transformer as tfm

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        native_build = start_native_build()
        print(f"kernel build: per source {_build.build()}")
        build_s = native_build()
        print(f"native build: g++ s {build_s}")
        drive_native(torch, np, tfm, card_line, build_s)
        print(card_line)
        return 0
    if args == ["--tools"]:
        # phase 22 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        from zhpe_ompi_tpu_torch import _build
        from zhpe_ompi_tpu_torch.models import transformer as tfm

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        print(f"kernel build: per source {_build.build()}")
        drive_tools(torch, np, tfm, card_line)
        print(card_line)
        return 0
    if args == ["--osc-io"]:
        # phase 21 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        from zhpe_ompi_tpu_torch import _build
        from zhpe_ompi_tpu_torch.models import transformer as tfm

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        print(f"kernel build: per source {_build.build()}")
        drive_osc_io(torch, np, tfm, card_line)
        print(card_line)
        return 0
    if args == ["--ft-dvm-child"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return ft_dvm_child()
    if len(args) == 2 and args[0] == "--serve-child" and args[1] in ("kill", "elastic"):
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        return serve_child(args[1])
    if args == ["--serve"]:
        # phase 20 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        from zhpe_ompi_tpu_torch import _build
        from zhpe_ompi_tpu_torch.models import transformer as tfm

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        print(f"kernel build: per source {_build.build()}")
        drive_serve(torch, np, tfm, card_line)
        print(card_line)
        return 0
    if args == ["--hybrid"]:
        # phase 19 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        from zhpe_ompi_tpu_torch import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        print(f"kernel build: per source {_build.build()}")
        drive_hybrid(torch, card_line)
        print(card_line)
        return 0
    if args == ["--ft"]:
        # phases 17 and 18 alone, after the kernel build
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        from zhpe_ompi_tpu_torch import _build
        from zhpe_ompi_tpu_torch.models import transformer as tfm
        from zhpe_ompi_tpu_torch.ops import flash_attention as fa
        from zhpe_ompi_tpu_torch.ops import fused_norm

        card_line = _card_line()
        print(f"card: {card_line}")
        print(f"kernel build: per source {_build.build()}")
        drive_ft(torch, np, tfm, fused_norm, fa, card_line)
        drive_ft_processes(torch, card_line)
        drive_ft_dvm(torch, card_line)
        print(card_line)
        return 0
    if args == ["--host-plane"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        _take_widths()
        import numpy as np

        torch.backends.cuda.matmul.allow_tf32 = False
        card_line = _card_line()
        print(f"card: {card_line}")
        check_host_plane(torch, np, card_line)
        drive_host_moe_both(torch, card_line)
        print(card_line)
        return 0
    if args and (args[0] != "--wrapper-host-us" or len(args) != 2):
        print("usage: chip_smoke.py [--bench-after | --wrapper-host-us PORT_ROOT "
              "| --compare-host-us OTHER_ROOT [PAIRS] | --host-plane "
              "| --host-moe-child | --ft | --ft-child | --ft-dvm-child | --hybrid "
              "| --hybrid-child | --serve | --serve-child kill|elastic "
              "| --osc-io | --osc-io-child | --tools "
              "| --tools-child traced|names|abort [DIR] | --native "
              "| --native-child]",
              file=sys.stderr)
        return 2
    if args:
        # the wrappers' and the communicator's host cost of the port found
        # under PORT_ROOT (for example an unpacked older commit), on this card
        sys.path.insert(0, os.path.abspath(args[1]))
        _take_widths()
        import torch.distributed as dist

        import zhpe_ompi_tpu_torch as zmpi
        from zhpe_ompi_tpu_torch.ops import flash_attention as fa
        print(json.dumps({"wrapper_host_us": wrapper_host_us(torch, fa),
                          "comm_allreduce_host_us": comm_allreduce_host_us(
                              torch, zmpi, dist),
                          "port_root": args[1], "card": _card_line()}))
        return 0
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    _take_widths()
    import numpy as np
    import torch.distributed as dist
    import torch.nn.functional as F

    import zhpe_ompi_tpu_torch as zmpi
    from zhpe_ompi_tpu_torch import _build
    from zhpe_ompi_tpu_torch.coll import nccl, tuned
    from zhpe_ompi_tpu_torch.mca import var as mca_var
    from zhpe_ompi_tpu_torch.models import ring_attention as ra
    from zhpe_ompi_tpu_torch.models import transformer as tfm
    from zhpe_ompi_tpu_torch.ops import flash_attention as fa
    from zhpe_ompi_tpu_torch.ops import fused_ce, fused_norm

    # the reference comparisons run f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card_line = _card_line()
    print(f"card: {card_line}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    native_build = start_native_build()  # g++ beside nvcc
    seconds = _build.build()
    print(f"kernel build: {time.perf_counter() - t0} s wall, per source {seconds}")
    native_build_s = native_build()
    print(f"native build: {time.perf_counter() - t0} s wall, g++ s {native_build_s}")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error",
                                       "warning")):
                print(f"  nvcc {name}: {line.strip()}")

    kernels = [check_layernorm(torch, F, fused_norm),
               check_layernorm_bwd(torch, fused_norm),
               check_flash(torch, F, fa), *check_flash_bwd(torch, F, fa)]
    ring = check_ring_recurrence(torch, ra)
    host_us = wrapper_host_us(torch, fa)
    print(json.dumps({"wrapper_host_us": host_us, "card": card_line}))
    for k in kernels:
        if k["name"] == "flash_attention_fwd":
            k["host_us_per_call"] = host_us["flash_fwd"]
        elif k["name"] == "flash_attention_bwd_dq":
            k["host_us_per_call"] = host_us["flash_bwd_dq"]
        elif k["name"] == "flash_attention_bwd_dkv":
            k["host_us_per_call"] = host_us["flash_bwd_dkv"]

    # the MPI entry point first: no process group is up yet, and the bench
    # it runs times steps in a process no profiler session has touched
    rt_launches, lc_launches, runtime = drive_runtime(torch, np, dist, tfm, fused_norm,
                                                      fa, card_line)
    with tempfile.TemporaryDirectory() as store_dir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
            rank=0, world_size=1)
        try:
            tp_comm = zmpi.Communicator(name="tp")
            dp_comm = tp_comm.dup(name="dp")
            sp_comm = tp_comm.dup(name="sp")
            probe = torch.ones(4, device="cuda")
            for comm in (tp_comm, dp_comm, sp_comm):
                # tuned serves every collective; its route for a SUM
                # allreduce is the native one, coll/nccl
                if ({c for _, c in comm.coll.values()} != {"tuned"}
                        or tuned.decide("allreduce", comm, probe, zmpi.SUM) != "xla"
                        or comm.backend != "nccl"):
                    raise SystemExit(f"{comm.name} did not compose tuned over "
                                     f"coll/nccl: {comm.coll}")
            checked, allreduce_host = check_collectives(torch, dp_comm, zmpi, tuned,
                                                        nccl, mca_var)
            fwd_launches, t_fwd, t_loss = drive_main_path(
                torch, np, tfm, fused_ce, fused_norm, fa, tp_comm)
            launches, steady, flash_loss = drive_train(torch, np, tfm, fused_norm, fa,
                                                       dp_comm, tp_comm)
            remat_launches, remat_steady = drive_remat(
                torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, steady)
            sp = drive_sp(torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, sp_comm,
                          flash_loss)
            adam_launches, adam_steady, ckpt, adam_cmp = drive_adam(
                torch, np, tfm, fused_norm, fa, dp_comm, tp_comm, steady, card_line)
            moe_pipe = check_moe_pipeline(torch, np, tp_comm, card_line)
            device_plane = check_device_plane(torch, np, dp_comm, card_line)
            late = (bench_after_profiling(torch, tfm, dp_comm, tp_comm, runtime,
                                          card_line) if bench_after else None)
        finally:
            dist.destroy_process_group()
    host_plane = check_host_plane(torch, np, card_line)
    host_moe = drive_host_moe_both(torch, card_line)
    ft_launches, ft = drive_ft(torch, np, tfm, fused_norm, fa, card_line)
    ft_processes = drive_ft_processes(torch, card_line)
    ft_dvm = drive_ft_dvm(torch, card_line)
    hybrid = drive_hybrid(torch, card_line)
    serve = drive_serve(torch, np, tfm, card_line)
    osc_io = drive_osc_io(torch, np, tfm, card_line)
    tools = drive_tools(torch, np, tfm, card_line)
    native = drive_native(torch, np, tfm, card_line, native_build_s)
    native_launches = {"layernorm_fwd": native["launches_per_forward"].get("ln_fwd", 0),
                       "flash_attention_fwd":
                           native["launches_per_forward"].get("flash_fwd", 0)}
    tools_launches = {"layernorm_fwd": tools["launches_per_forward"].get("ln_fwd", 0),
                      "flash_attention_fwd":
                          tools["launches_per_forward"].get("flash_fwd", 0)}
    osc_launches = {"layernorm_fwd": osc_io["launches_per_forward"].get("ln_fwd", 0),
                    "flash_attention_fwd":
                        osc_io["launches_per_forward"].get("flash_fwd", 0)}
    serve_launches = {"layernorm_fwd": serve["launches_per_step_and_rank"]["ln_fwd"],
                      "flash_attention_fwd":
                          serve["launches_per_step_and_rank"]["flash_fwd"]}
    for k in kernels:
        # ``launches``: per training step; the other paths beside it
        k["launches"] = launches[k["name"]]
        k["launches_by_path"] = {
            "forward": fwd_launches[k["name"]] // (2 * N_BATCHES),
            "train": launches[k["name"]], "remat": remat_launches[k["name"]],
            **{label: sp[label][0][k["name"]] for label in sp},
            "runtime": rt_launches[k["name"]],
            "long_context": lc_launches[k["name"]],
            "adam": adam_launches[k["name"]], "ft": ft_launches[k["name"]],
            "hybrid": hybrid["launches_per_step"]["hybrid"][k["name"]],
            "zero": hybrid["launches_per_step"]["zero"][k["name"]],
            "serve": serve_launches.get(k["name"], 0),
            "osc_io": osc_launches.get(k["name"], 0),
            "tools": tools_launches.get(k["name"], 0),
            "native": native_launches.get(k["name"], 0)}
    steps = {"train": steady, "remat": remat_steady,
             **{label: sp[label][1] for label in sp}, "adam": adam_steady}
    print(json.dumps({"steps": steps, "card": card_line}))
    print(json.dumps({"kernels": kernels, "card": card_line,
                      "forward_s": t_fwd, "loss_fn_s": t_loss,
                      "train_step_median_ms": steady["median_ms"],
                      "ring_recurrence": ring, "collectives_checked": checked,
                      "allreduce_host_us_per_call": allreduce_host,
                      "runtime": runtime, "bench_after_profiling": late,
                      "checkpoint": ckpt, "adam_vs_plain": adam_cmp,
                      "moe_pipeline": moe_pipe, "device_plane": device_plane,
                      "host_plane": host_plane, "host_moe": host_moe,
                      "ft": ft, "ft_processes": ft_processes, "ft_dvm": ft_dvm,
                      "hybrid": hybrid, "serve": serve, "osc_io": osc_io,
                      "tools": tools, "native": native,
                      "smoke_s": time.perf_counter() - t_start}))
    print(f"smoke total: {time.perf_counter() - t_start} s")
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
