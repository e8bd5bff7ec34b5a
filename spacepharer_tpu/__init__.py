"""spacepharer_tpu — a GPU-accelerated CRISPR spacer vs. phage genome matching framework.

A from-scratch JAX/XLA re-design of the capabilities of
soedinglab/spacepharer. The host engines are native C; the device
engines (dense k-mer prefilter, Smith-Waterman candidate scoring) run
on an NVIDIA GPU through XLA and a CUDA kernel called through jax.ffi.
The surrounding data model is packed NumPy arrays instead of the
reference's text key-value databases.

Layer map (mirrors SURVEY.md §7):
  io/        FASTA + spacer-tool-format parsers, packed SetDB artifact store
  ops/       sequence kernels: translate, ORF finding, substitution matrices,
             k-mer prefilter, Smith-Waterman, E-values (JAX/CUDA/C)
  stats/     best-hit P-values, S_comb aggregation, FDR calibration
  report/    ORF->contig offsets, nucleotide re-alignment, PAM scan, TSV writers
  tax/       NCBI taxonomy, LCA, rank restriction
  parallel/  device-mesh sharding of the target index + collective hit merge
  pipeline/  workflow orchestration with content-hash artifact resume
"""

__version__ = "0.1.0"


def _tune_allocator():
    """Keep freed large blocks inside the process arena.

    NumPy routes big temporaries through malloc; glibc's default policy
    mmaps and munmaps them, so every pipeline stage re-pays the page
    fault cost of its buffers. Under a hypervisor first-touch faults
    can run far slower than warm memory, which makes allocation a top
    cost of the host pipeline. Raising
    M_MMAP_THRESHOLD and disabling trim makes the fault cost a one-time
    high-water-mark charge. (Same concern the reference addresses by
    vendoring nedmalloc, lib/mmseqs/lib/nedmalloc.)
    """
    import ctypes
    import sys
    if not sys.platform.startswith("linux"):
        return
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, -1)
    except OSError:
        pass


_tune_allocator()


def _default_jax_cache():
    """Persistent XLA compilation cache.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is
    set here. Otherwise the cache lives at a fixed path inside the
    checkout (`<repo>/.jax_cache`): the path is part of the cache key,
    so a directory that moves never hits."""
    import os
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        return
    os.environ["JAX_COMPILATION_CACHE_DIR"] = d
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
    import sys
    if "jax" in sys.modules:
        # jax read its environment at import; apply through the live
        # config (does not initialize a backend)
        import jax
        jax.config.update("jax_compilation_cache_dir", d)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)


_default_jax_cache()
