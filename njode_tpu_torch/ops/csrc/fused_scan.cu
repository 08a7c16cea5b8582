// Hand-written Hopper kernels for the NJODE training scan (sm_90a).
//
// Replaces the Pallas TPU kernels of njode_tpu/ops/fused_scan.py, all
// their branches (unmasked, masked: _step_forward / _step_backward's
// imputation path, and the GRU jump: _gru_fwd / _gru_bwd):
//   njode_scan_fwd_kernel<true>   K1  _fwd_impl / _make_fwd_kernel (training forward, histories)
//   njode_scan_fwd_kernel<false>  K3  make_fused_eval_fn (eval loss, no histories, no dropout)
//   njode_remat_kernel            K2  _fused_bwd / _make_bwd_kernel (hand-written BPTT),
//   njode_scan_bwd_kernel             stage (a) the forward re-run, (b) the chain,
//   njode_wgrad_kernel                (c) the weight gradients (_acc_wb)
//   mask words (fill_lanes)       K4  _step_masks (per-step dropout keep-masks)
//   philox_masks_kernel               the same masks written out (tests, timing)
//   reduce_partials               the in-kernel accumulation of the TPU grid (loss_ref +=, _acc_wb)
//
// Design. The scan is K sequential steps of tiny matmuls (widths <= ~50,
// batch rows 50-4000). One CTA owns R batch rows and walks all K steps
// itself; all weights (resident plan, below), carries and per-step
// activations live in dynamic shared memory, so a step touches device
// memory only for its per-step inputs (t, dt, obs, X, masks) and the
// history rows. Each output is one fp32 FMA chain over its summed index,
// upwards, by one thread. K2 runs as three stages a chunk of Kc steps, last
// chunk first (K2's C call, as K6 in fused_gob.cu): (a) re-runs every
// (step, row) pair of the chunk at once from the stored step-entry
// carries (h, last_X, tau), with the forward's own code, and writes every
// forward value the backward reads to a workspace record of the pair; (b)
// the chain walks k = k1-1..k0 at R rows a CTA, the carries' gradients
// passing from chunk to chunk through device memory, reads each step's
// records with cp.async while the step before works, and writes the
// gradient of every Linear's output (its delta) to the records; (c) sums
// d^T x over the records of each stretch of ceil(512 / B) steps for every
// leaf into the stretch's partial row; reduce_partials then sums the
// partials in a fixed order (no float atomics: results are bit-identical
// run to run, and the order depends neither on R, nor on the plan, nor on
// the chunk, nor on a member axis).
//
// Bound on this card. The work is ~25,600 FLOP per row-step at the main
// path (12,800 MACs) - at B=200, K=100 that is 0.51 GFLOP, 7.6 us at the
// 67 TFLOP/s fp32 peak, and ~1 MB of traffic (0.3 us at 3.35 TB/s), so the
// bound is operations. What actually limits these kernels is latency: the
// K-step chain is sequential, and a step is a chain of dependent phases.
// At 16 rows a CTA the training batches (B = 100-200) would hold 7-13 of
// the 132 SMs, and a layer a phase with its activation in another would
// run about 19 barriers a K1 step and 32 a K2 step. The resident plan
// takes one row a CTA at the training batches (Spec.rows_for: the
// fewest rows at which every CTA is resident at once, CTAS_PER_SM at most)
// and fuses phases ("the resident plan", below): 7 a K1 step, 7 a step of
// K2's chain on the main path. Splitting a product over lanes would part
// the two plans' bits; it is later work for both plans (ROADMAP).
//
// Masked branch (c.masked). The pre-jump readout imputes the unobserved
// coordinates, X_imp = X*M + (1-M)*y_bj, and the encoder reads
// [tanh X_imp, M] (2D wide) with its residual on X_imp (D wide), so a step
// runs four MLP passes one after another: ODE, pre-jump readout (R rows,
// slots s_r1), encoder, post-jump readout (R rows, slots s_r2, MLPDesc
// ro2: the same weights, its own saved activations). The loss weighs each
// coordinate by M, and last_X takes the post-jump prediction y at observed
// rows, so the backward adds obs*dlast_X to dy and carries (1-M)*dX_imp
// into dy_bj before the pre-jump readout's backward.
//
// GRU jump (c.use_rnn, a runtime branch like c.masked). At observed rows
// h' = GRUCell(tanh X, h_t), h_t = tanh h1, on the raw observation whether
// masked or not, in torch's gate order r, z, n: gate g is row g*H + j of
// weight_ih [3H, D] and weight_hh [3H, H] (leaf offsets c.gru_*), and
//   r = sig(gi_r + gh_r), z = sig(gi_z + gh_z), n = tanh(gi_n + r*gh_n),
//   h' = (1-z)*n + z*h_t,  h2 = obs*h' + (1-obs)*h1,
// with b_hh_n inside gh_n. It takes the encoder's place; the encoder runs
// only at t=0, outside (its dropout slots stay in S, unused). Both readouts
// then run as one stacked pass even when masked, and a masked config keeps
// its M-weighted loss and last_X = y. gru_fwd gives a thread one (row, j)
// and all three gates' sums (tanh X from tX [R, D], h_t from in_ro[0:R*H])
// and saves (r, z, n, gh_n) in region gru [4][R*H]. gru_bwd writes the
// gate gradients da_r, da_z, da_n = dgi_n and dgh_n = r*da_n (the gradient
// of b_hh_n and the hh row of n: r scales gh_n) to dG [R, 4H], then adds
// the four leaves' gradients (X is data: no dx) and dh1 += (dh'*z +
// sum_g dgh_g W_hh[g]) * (1 - h_t^2).
//
// Dropout masks. 'input' mode reads int8 keep-masks [K,S,B,Wmax]; 'prng'
// mode draws Philox4x32-10 (philox.cuh, shared with the GRU-ODE-Bayes
// kernels) with key (seed_lo, seed_hi) and counter
// (col >> 2, global_row, k, slot), word col & 3, kept iff word < thresh.
// The counter depends only on the global row and column, never on the CTA
// split or the layer width, so the backward redraws the forward's masks.
// A step's masks live as bits in shared memory (region mw: per row and
// slot c.nw words of 32 columns), one draw giving a quad's four bits, and
// applying a mask is a bit test (keep_at). The words of the next step (K1)
// or of the step before (K2) are filled while a step runs, by lanes of the
// warps its phases leave idle (items_fill; the resident plan keeps two
// sets, by the parity of the step), so a draw is off the step's chain, K2
// draws a step once for its re-materialisation and its dx, and no barrier
// is added; in the global plan one set is filled at the end of each step.
// 'input' mode fills the same words from u, so both modes share the bit
// test. A word takes eight lanes, a draw each, where a phase leaves that
// many threads idle (at one row the step's 16 words fill in its first
// phase, 128 lanes), else a thread, its eight draws (at 16 rows the 256
// words left over a pass of the CTA).
//
// Two plans (c.plan; the counterpart of the JAX kernel's _select_plan /
// _block_plan, which cut nets that overflow VMEM into K-chunks and batch
// blocks). 'resident' (GW = false): every weight sits in shared memory, as
// above. 'global' (GW = true), for nets whose weights do not fit one CTA
// (the 160- to 400-wide arms, PhysioNet's 200 arm): the weights stay in
// one packed fp32 buffer in device memory (each leaf at a 16-byte
// boundary, Spec.pack_off). Its K2 has no stage (a): its chain re-runs
// each step inline through the ring and writes the Linears' inputs to the
// records itself (queued: stage (a) for this plan). Only activations live
// in shared memory, and R
// (c.rows) is the largest of 16, 8, 4, 2, 1 whose activations fit. Each
// kernel is built over R (template RT): R = 16 and (resident plan) R = 1
// as compile-time constants, so the row loops unroll (read at run time, R
// slowed the resident K2 by 12 %), and R read from c.rows.
//
// The global plan's weights reach the FMA chains through shared memory.
// Reading them through __ldg put an L2 round trip on every link of each
// column's serial sum (one load in flight a thread, 8 warps an SM: K2 ran
// at 0.07 % of its fp32 bound). Now the ring (the region left after the
// activations, two stages) holds weight tiles that cp.async copies in the
// background: acquiring tile t waits for it, syncs, and starts the copy of
// tile t + 1 into the other stage, so each copy overlaps the arithmetic of
// the tile before it, across layers, MLPs and steps. The host lists a
// step's tiles in the order the kernels consume them (Spec.tile_program:
// the forward's, then K2's backward), and every consumer checks the
// descriptor's key. A forward product y = W x takes column blocks
// [out x T] of W (bias on the last) and dx = W^T d row blocks [T x in];
// the GRU's gates run as two such products into the region gsc. A thread
// keeps its outputs (a column of up to RB rows, MAXI of them a pass) in
// registers across tiles, walking the summed index upwards, so each sum
// runs in the resident plan's order and both plans give the same bits at
// one R. The passes stay inlined into the six global kernel
// instantiations, which makes this file slow to build (nvcc 249 s on the
// H100 machine): compiled once each, out of line (__noinline__ mlp_fwd,
// mlp_bwd, gru_fwd and gru_bwd), they built in 28 s but ran 35-47 %
// slower on the card (PERF.md).
//
// The layer table. Each net's layers (widths, activation, offsets of
// their weights and biases and of their saved activations) and the
// leaves' offsets and addresses live in one small device buffer the host
// builds once per config and leaf addresses (LayerRec), not in the
// kernels' parameter block, which holds ScanCfg (a net: its depth, first
// record, input width, first dropout slot and save offset) and pointers
// alone: 544 bytes. Each CTA copies the records into shared memory at
// entry (region lay), where every phase reads them, so a net's depth has
// no cap but the shared memory of its activations, mask words and
// records, which the host's plan counts. A hidden layer's save offset is
// the host's prefix sum of the widths below it, so no loop over the
// earlier layers runs per call.
//
// K2's workspace (ops/fused_scan.py Spec.ws_fields). A record of c.rec
// floats a (step, row) pair, [Kc * B] records a chunk (a member's after
// the member before): first the forward values, the Linears' inputs (the
// nets' inputs, the hidden layers' post-dropout activations; stage (c)
// reads them) and what only the chain reads (h1, h2, the readouts'
// outputs and error terms, the pre-activations, the GRU's gates, the mask
// words: a dropped tanh unit does not show in its saved activation), then
// the deltas. A copy program lists a float of a record a line (index,
// shared offset, row stride: put_fields / get_fields): stage (a) writes
// the forward floats from its layout, the global chain the Linears'
// inputs from its own, and the resident chain reads them into one of two
// io sets, each holding a step's inputs and forward values, so the next
// step's copies run while a step works on the other. A Linear's delta
// goes to its record offset (LayerRec.dlt; the stacked readout's second
// half, or the masked branch's post-jump pass, MLPDesc.dhalf, w_out
// further), the GRU's to c.dlt_gru. Stage (c) owns a [32, 32] tile of a
// weight (its bias one column more, of ones) and a stretch of steps a
// CTA, and walks the leaf's jobs (x, d: the readout's two halves two
// jobs), the next 32 records' tiles loaded into registers while it sums
// the ones before. A chunk is
// a multiple of the stretch, as long as keeps the workspace of the launch
// (all its members) under 32 MiB.
//
// reduce_partials. The scan kernels' C entries enqueue it themselves on
// the same stream right after K1/K3 (the loss, [n_cta, 1]) and K2 (the
// gradients): one launch more on the device, no Python call and no second
// ctypes trip on the host. (The alternative, the last CTA of K1 summing the
// loss after a ticket, would cover only the loss.) A thread sums one
// column; its bound is bytes, (n_parts + 1) * n * 4. Two bodies shaped for
// bandwidth were no faster on the card (float4 loads on rows padded to 16
// bytes: the same device time; 4 columns a thread with 8 rows' loads ahead:
// 3-4x slower; PERF.md), so the kernel kept its first body.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"          // K4: philox_keep4, mask words, mask rows
#include "dtx.cuh"             // K2 stage (c): the d^T x tiles

#define MAX_ROWS 16            // batch rows per CTA: c.rows in 1..MAX_ROWS
#define RB 4                   // rows a thread sums in the global plan
#define NTHREADS 256
#define LAYER_INTS 8           // ints of a layer's record (LayerRec)
#define MAXI 4                 // global plan: items a thread keeps over tiles
#define TILE_INTS 8            // ints of a tile descriptor (tile_program)
#define CTAS_PER_SM 2          // resident kernels: CTAs an SM holds at most
#define WG_TILE 32             // K2 stage (c): output tile [32, 32] of a leaf
static_assert(WG_TILE == DTX_TILE, "stage (c) tiles are dtx.cuh's");

// One Linear layer of an MLP: a record of the layer table (above; built
// by ops/fused_scan.py layer_table): the nets' records one after another
// (the masked branch's post-jump readout shares the readout's), then the
// leaves' offsets in the flat parameters (n_leaves + 1 ints, at
// c.tab_leaves) and their device addresses (at c.tab_ptrs, 8-byte
// aligned).
struct LayerRec {
  int w_in, w_out;           // the layer's input and output widths
  int act;                   // a hidden layer's activation: 0 tanh, 1 relu
  int w_off;                 // weight [out, in] offset in the flat params
  int b_off;                 // bias offset, -1 without bias
  int pw_off;                // the weight's offset in the packed buffer
  int save;                  // the widths of the hidden layers below it,
                             // summed: its saved pair at save_off + 2 *
                             // rows * save
  int dlt;                   // K2: its output's gradient in the workspace
                             // record (rows of the second stacked half, or
                             // of a net with dhalf, w_out further), -1 none
};

struct MLPDesc {
  int n_lin;                 // Linear layers (hidden layers + 1)
  int w_in;                  // the net's input width
  int lay;                   // its first layer's record in the table
  int slot0;                 // dropout slot of hidden layer 0
  int save_off;              // smem offset of the saved pre-acts / acts
  int dhalf;                 // 1: the masked branch's post-jump readout,
                             // whose deltas take the records' second half
};

// Mirrored field by field by ops/fused_scan.py::_ScanCfg (all 4-byte fields).
struct ScanCfg {
  int K, B, D, H, O, S, Wmax, n_params, n_leaves;
  int enc_case, enc_mult, ro_case, ro_mult, easy, ict, mode, masked, use_rnn;
  unsigned int thresh;
  float keep, weight;
  int rows, plan, buf_w, smem_floats;   // plan: 0 resident, 1 global
  int gru_wih, gru_whh, gru_bih, gru_bhh;   // GRU leaf offsets, -1: none
  int gru_pwih, gru_pwhh;      // the GRU weights in the packed buffer
  int n_tiles_fwd, n_tiles_bwd, stage;   // global plan: tiles a step, stage
  int io_stride;               // resident plan: floats between the io sets
  int wg_stride;               // global plan: floats of one member's packed
                               // weights (a member-axis launch)
  int n_rec, tab_leaves, tab_ptrs;   // the layer table: records, and the
                                     // ints before its leaf offsets and
                                     // before its leaf addresses
  int rec, dlt_gru;            // K2's workspace: floats of a (step, row)
                               // record; the GRU's dgi [3H] there (dgh
                               // [3H] after it), -1 without use_rnn
  int o_w, o_h, o_lx, o_tau, o_X, o_obs, o_nobs, o_lrow, o_h1, o_h2;
  int o_in_ode, o_tX, o_in_ro, o_f, o_enc, o_ro, o_dA, o_dB, o_dh, o_dlx;
  int o_dtau, o_rs, o_dst, o_dh1, o_dhe, o_df, o_dlxc, o_dtauc, o_M, o_Xi;
  int o_gru, o_dG;             // use_rnn only: saved gates, gate gradients
  int o_gsc, o_ring;           // global plan: GRU gate sums, weight ring
  int o_tdt, o_le;             // resident plan: the io set's t and dt, the
                               // loss's error terms
  int o_mw;                    // the mask words (two sets resident, one global)
  int o_lay;                   // the layer records (LayerRec)
  int nw, lg_nw;               // mask words of a row and slot, ceil(Wmax /
                               // 32), and log2 of the power of two >= nw
  int skip0, skip1;            // slots a step does not use (the encoder's
                               // with the GRU jump): none drawn
  MLPDesc ode, enc, ro, ro2;   // ro2: the masked branch's post-jump pass
};

// layer l of net m: its record in the CTA's copy of the table
__device__ __forceinline__ const LayerRec& layer(const ScanCfg& c,
                                                 const float* sm,
                                                 const MLPDesc& m, int l) {
  return reinterpret_cast<const LayerRec*>(sm + c.o_lay)[m.lay + l];
}

struct MaskCtx {
  int mode;                  // 0 none, 1 input masks, 2 philox
  const int8_t* u;
  uint32_t k0, k1, thresh;
  int row0, nv, half, jump, B, S, Wmax, nw, lg_nw, skip0, skip1;
  float keep;
  const uint32_t* bits;      // the step's mask words
};

// keep-mask of hidden slot `slot` at local row r (stacked rows r >= half
// belong to the second readout, slot + jump), column col: a bit of step
// k's words (a padding row of the last CTA keeps every column)
__device__ __forceinline__ bool keep_at(const MaskCtx& m, int slot, int r,
                                        int col) {
  int lr = r;
  if (r >= m.half) { lr = r - m.half; slot += m.jump; }
  return (m.bits[(lr * m.S + slot) * m.nw + (col >> 5)] >> (col & 31)) & 1u;
}

// the mask words of a step being filled: R * S * 2^lg_nw of them (the
// words of a row and slot padded to a power of two; fill_words), `done`
// of them so far
struct Fill {
  uint32_t* words;           // the step's set
  int k, done, total, rows;  // the step; words done, words in all (0:
                             // none); the CTA's rows
};

// the set of step k's mask words: by the parity of k in the resident plan
// (one step's set is read while the other is filled), the one set in the
// global plan
__device__ __forceinline__ uint32_t* mask_set(const ScanCfg& c, float* sm,
                                              int R, int k) {
  return (uint32_t*)(sm + c.o_mw) + (c.plan ? 0 : (k & 1) * R * c.S * c.nw);
}

__device__ __forceinline__ Fill fill_of(const ScanCfg& c, float* sm, int R,
                                        const MaskCtx& mc, int k) {
  const bool on = mc.mode && k >= 0 && k < c.K;
  return Fill{mask_set(c, sm, R, k), k, 0,
              on ? R * c.S * (1 << c.lg_nw) : 0, R};
}

// Word v of step k's set (v = (r * S + slot) * 2^lg_nw + w: the words of
// a row and slot padded to a power of two, so only the row takes a
// division, and none at one row): false for a padding word (w >= nw),
// else its row r, slot, w and where it goes.
struct WordAt {
  int r, slot, w, at;
};

__device__ __forceinline__ bool word_at(const MaskCtx& m, int rows, int v,
                                        WordAt& a) {
  a.w = v & ((1 << m.lg_nw) - 1);
  if (a.w >= m.nw) return false;
  const int rs = v >> m.lg_nw;           // r * S + slot
  a.r = rows == 1 ? 0 : rs / m.S;
  a.slot = rs - a.r * m.S;
  a.at = rs * m.nw + a.w;
  return true;
}

// The keep bits of quad q of word a's row and slot (every slot draws Wmax
// columns, a narrower layer reading the first of them, but the unused
// ones), or all kept on a padding row
__device__ __forceinline__ uint32_t word_quad(const MaskCtx& m, int k,
                                              const WordAt& a, int q) {
  if (a.r >= m.nv) return 0xFu;
  const int grow = m.row0 + a.r;
  const int8_t* ur = m.mode == 1
      ? m.u + (((size_t)k * m.S + a.slot) * m.B + grow) * m.Wmax : nullptr;
  const int width = a.slot >= m.skip0 && a.slot < m.skip1 ? 0 : m.Wmax;
  return quad_bits(m.mode, ur, m.k0, m.k1, m.thresh, q, width, grow, k,
                   a.slot);
}

// Words e0 .. e0 + take - 1 of step k's set at `words` by eight lanes a
// word, a draw each: the CTA's thread t is lane e = t - lane0 (one pass,
// take * 8 <= NTHREADS - lane0), of word e0 + (e >> 3) and its quad 8w +
// (e & 7), the eight nibbles combined by lanes_word (lane0, a multiple of
// 32, keeps a word's lanes in one warp). Out of line and by value, so the
// kernels' item code stays as it was.
__device__ __noinline__ void fill_lanes(MaskCtx m, uint32_t* words, int k,
                                        int rows, int e0, int lane0,
                                        int take) {
  const int e = (int)threadIdx.x - lane0;
  WordAt a;
  if (e < 0 || e >= 8 * take || !word_at(m, rows, e0 + (e >> 3), a)) return;
  const uint32_t word = lanes_word(word_quad(m, k, a, 8 * a.w + (e & 7)));
  if ((e & 7) == 0) words[a.at] = word;
}

// The same words a thread each, its eight draws, the CTA's thread t taking
// word e0 + e, e = t - lane0 (+ NTHREADS, ...): for what is left at a
// step's last phase, where few threads are idle.
__device__ __noinline__ void fill_words(MaskCtx m, uint32_t* words, int k,
                                        int rows, int e0, int lane0,
                                        int take) {
  for (int e = (int)threadIdx.x - lane0; e < take; e += NTHREADS) {
    WordAt a;
    if (e < 0 || !word_at(m, rows, e0 + e, a)) continue;
    uint32_t word = 0u;
#pragma unroll 4
    for (int j = 0; j < 8; ++j)
      word |= word_quad(m, k, a, 8 * a.w + j) << (4 * j);
    words[a.at] = word;
  }
}

// A phase's n items (item(idx), in passes of the CTA's threads), then
// (f not null) words of f from f.done on, by the threads past the items
// of the last pass (from the first whole warp there): as many as that
// pass's idle threads hold at eight lanes a word (fill_lanes), or, where
// `last`, all that are left at a word a thread (fill_words, in passes of
// their own if need be). Two phases of a step take words: its first (at
// one row a CTA all of them fit there) and its last (the rest). The words
// are drawn after the item loop, so the items' code is the same with
// masks and without.
template <class F>
__device__ __forceinline__ void items_fill(const MaskCtx& mc, Fill* f, int n,
                                           bool last, const F& item) {
  for (int idx = threadIdx.x; idx < n; idx += NTHREADS) item(idx);
  if (!f) return;
  int take = f->total - f->done;
  if (take <= 0) return;
  const int lane0 = n > 0 ? ((n - 1) % NTHREADS + 32) & ~31 : 0;
  if (!last) {
    take = min(take, (NTHREADS - lane0) >> 3);
    if (take > 0)
      fill_lanes(mc, f->words, f->k, f->rows, f->done, lane0, take);
  } else {
    fill_words(mc, f->words, f->k, f->rows, f->done, lane0, take);
  }
  f->done += take;
}

__device__ __forceinline__ float act_f(int a, float x) {
  return a == 0 ? tanhf(x) : fmaxf(x, 0.f);
}

__device__ __forceinline__ float act_grad(int a, float pre) {
  if (a == 0) { float t = tanhf(pre); return 1.f - t * t; }
  return pre > 0.f ? 1.f : 0.f;
}

// ------------------------------------------- the global plan's weight ring

// Asynchronous copies from device into shared memory (cp.async); a host
// build of these bodies (a CPU rehearsal) copies at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The ring: two stages of `stage` floats at buf; tile t goes to stage t & 1.
// prog lists one step's tiles (n of them; the list repeats every step),
// TILE_INTS ints each: src (float offset in the packed weights), rows,
// stride (floats between rows in the packed buffer), cols, flags (1: the
// op's last tile, 2: a dx tile), bsrc (the bias's offset, copied after the
// tile, or -1), key (the op's weight offset), unused.
struct Ring {
  const int* prog;
  int n, t, stage;
  float* buf;
  const float* wg;
};

struct Tile {
  const float* w;            // [rows x cols] in shared memory
  const float* b;            // the bias, or null
  int s0, ns, last;          // the summed index's block, the op's last tile
};

// start the copy of tile t into its stage (every thread takes a share)
__device__ void ring_issue(const Ring& rg, int t) {
  const int* d = rg.prog + TILE_INTS * (t % rg.n);
  const int src = __ldg(d), rows = __ldg(d + 1), stride = __ldg(d + 2);
  const int cols = __ldg(d + 3), bsrc = __ldg(d + 5);
  float* dst = rg.buf + (t & 1) * rg.stage;
  const float* s = rg.wg + src;
  const int n = rows * cols;
  if (stride == cols) {                // one contiguous run
    if (((src | n) & 3) == 0)
      for (int e = 4 * threadIdx.x; e < n; e += 4 * NTHREADS)
        cp_async16(dst + e, s + e);
    else
      for (int e = threadIdx.x; e < n; e += NTHREADS)
        cp_async4(dst + e, s + e);
  } else if (((src | stride | cols) & 3) == 0) {  // 16-byte column blocks
    const int c4 = cols >> 2;
    for (int e = threadIdx.x; e < rows * c4; e += NTHREADS) {
      int r = e / c4, q = e - r * c4;
      cp_async16(dst + 4 * e, s + (size_t)r * stride + 4 * q);
    }
  } else {
    const int dr = NTHREADS / cols, dc = NTHREADS - dr * cols;
    int r = threadIdx.x / cols, q = threadIdx.x - r * cols;
    for (; r < rows; r += dr, q += dc) {
      if (q >= cols) { q -= cols; ++r; if (r >= rows) break; }
      cp_async4(dst + r * cols + q, s + (size_t)r * stride + q);
    }
  }
  if (bsrc >= 0)
    for (int j = threadIdx.x; j < rows; j += NTHREADS)
      cp_async4(dst + n + j, rg.wg + bsrc + j);
  cp_async_commit();
}

// Wait for the next tile (it must belong to the op `key` of kind `dx`),
// make it visible to the CTA and start the copy of the tile after it into
// the other stage, which every thread has finished reading at the barrier.
__device__ Tile ring_acquire(Ring& rg, int key, int dx) {
  cp_async_wait_all();
  __syncthreads();
  ring_issue(rg, rg.t + 1);
  const int* d = rg.prog + TILE_INTS * (rg.t % rg.n);
  const int src = __ldg(d), rows = __ldg(d + 1), cols = __ldg(d + 3);
  const int flags = __ldg(d + 4);
  if (__ldg(d + 6) != key || ((flags >> 1) & 1) != dx) __trap();
  Tile tl;
  tl.w = rg.buf + (rg.t & 1) * rg.stage;
  tl.b = __ldg(d + 5) >= 0 ? tl.w + rows * cols : nullptr;
  tl.s0 = dx ? (src - key) / cols : src - key;
  tl.ns = dx ? rows : cols;
  tl.last = flags & 1;
  rg.t++;
  return tl;
}

// acc[rr] += a(r0 + rr, s) * W(o, s) over the tile's block of s, upwards
template <bool DX, class A>
__device__ __forceinline__ void tile_sums(const Tile& tl, int n_o, int r0,
                                          int o, int nr, const A& a,
                                          float (&acc)[RB]) {
  const float* w = DX ? tl.w + o : tl.w + o * tl.ns;
  const int ws = DX ? n_o : 1;
  for (int s = 0; s < tl.ns; ++s) {
    float wv = w[s * ws];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
      if (rr < nr) acc[rr] = fmaf(a(r0 + rr, tl.s0 + s), wv, acc[rr]);
  }
}

// One weight op of the global plan through the ring: for r < rows and
// o < n_o, out(r, o, init(r, o) + sum_s a(r, s) * W(o, s) [+ b(o)]), the sum
// over s upwards. The forward kind (DX false) multiplies by W [n_o, n_s]
// (tiles: column blocks with the bias on the last); the dx kind by the
// transpose of W [n_s, n_o] (tiles: row blocks). A thread owns (row block
// q, output o) items, RB rows each: all of them within a tile when the op
// is one tile, else MAXI of them a pass over the op's tiles.
template <bool DX, class A, class I, class O>
__device__ void ring_op(Ring& rg, int key, int n_o, int rows, const A& a,
                        const I& init, const O& out) {
  const int n_items = (rows + RB - 1) / RB * n_o;
  Tile tl = ring_acquire(rg, key, DX);
  if (tl.last) {
    for (int idx = threadIdx.x; idx < n_items; idx += NTHREADS) {
      int q = idx / n_o, o = idx - q * n_o;
      int r0 = q * RB, nr = min(RB, rows - r0);
      float acc[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        acc[rr] = rr < nr ? init(r0 + rr, o) : 0.f;
      tile_sums<DX>(tl, n_o, r0, o, nr, a, acc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        if (rr < nr) out(r0 + rr, o, tl.b ? acc[rr] + tl.b[o] : acc[rr]);
    }
    return;
  }
  for (int base = 0; base < n_items; base += MAXI * NTHREADS) {
    float acc[MAXI][RB];
#pragma unroll
    for (int m = 0; m < MAXI; ++m) {
      int idx = base + m * NTHREADS + threadIdx.x;
      int q = idx / n_o, o = idx - q * n_o;
      int r0 = q * RB, nr = min(RB, rows - r0);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        acc[m][rr] = idx < n_items && rr < nr ? init(r0 + rr, o) : 0.f;
    }
    for (;;) {
#pragma unroll
      for (int m = 0; m < MAXI; ++m) {
        int idx = base + m * NTHREADS + threadIdx.x;
        if (idx < n_items) {
          int q = idx / n_o, o = idx - q * n_o;
          tile_sums<DX>(tl, n_o, q * RB, o, min(RB, rows - q * RB), a,
                        acc[m]);
        }
      }
      if (tl.last) break;
      tl = ring_acquire(rg, key, DX);
    }
#pragma unroll
    for (int m = 0; m < MAXI; ++m) {
      int idx = base + m * NTHREADS + threadIdx.x;
      if (idx < n_items) {
        int q = idx / n_o, o = idx - q * n_o;
        int r0 = q * RB, nr = min(RB, rows - r0);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr)
          if (rr < nr)
            out(r0 + rr, o, tl.b ? acc[m][rr] + tl.b[o] : acc[m][rr]);
      }
    }
    if (base + MAXI * NTHREADS < n_items) tl = ring_acquire(rg, key, DX);
  }
}

// K2's deltas: d [rows, w] (the gradient of a Linear's output, w = its
// width) into the workspace records of the CTA's valid rows at wsr (its
// first row's record of the step, rec floats a record), at record offset
// dlt; rows from `half` on are the second stacked half, w further on
__device__ __forceinline__ void put_delta(const float* d, int rows, int w,
                                          int half, int nv, float* wsr,
                                          int rec, int dlt) {
  for (int idx = threadIdx.x; idx < rows * w; idx += blockDim.x) {
    const int r = idx / w, j = idx - r * w;
    const int hf = r >= half, lr = hf ? r - half : r;
    if (lr < nv) wsr[(size_t)lr * rec + dlt + hf * w + j] = d[idx];
  }
}

// Copy floats of the workspace records between shared memory and the
// records of the CTA's rows at wsr (rec floats a record): the program fl
// lists n floats of a record, 3 ints each, its index in the record, its
// offset in shared memory and the floats between rows there (the fields
// of Spec.ws_fields, a float at a time); a thread takes a float and its
// rows in turn, so a row's consecutive floats go to consecutive threads.
// put_fields writes the CTA's nv valid rows (stage (a), and the global
// plan's chain); get_fields reads them back with cp.async and gives the
// rows past nv zeros (the resident chain at more than one row). Bit for
// bit: the mask words travel as fields.
__device__ void put_fields(const int* __restrict__ fl, int n, const float* sm,
                           float* wsr, int rec, int nv) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int ro = __ldg(fl + 3 * f), so = __ldg(fl + 3 * f + 1);
    const int ss = __ldg(fl + 3 * f + 2);
    for (int r = 0; r < nv; ++r)
      reinterpret_cast<uint32_t*>(wsr)[(size_t)r * rec + ro] =
          reinterpret_cast<const uint32_t*>(sm)[so + r * ss];
  }
}

// One row's forward floats, the record's first n, into the resident
// chain's io set at dst (its layout holds them as the record does: at one
// row a CTA the same image), 16 bytes a copy (both 16-byte aligned)
__device__ void get_record(float* dst, const float* src, int n) {
  const int n4 = n >> 2;
  for (int e = threadIdx.x; e < n4; e += blockDim.x)
    cp_async16(dst + 4 * e, src + 4 * e);
  for (int e = 4 * n4 + threadIdx.x; e < n; e += blockDim.x)
    cp_async4(dst + e, src + e);
  cp_async_commit();
}

__device__ void get_fields(const int* __restrict__ fl, int n, float* sm,
                           const float* wsr, int rec, int R, int nv) {
  for (int f = threadIdx.x; f < n; f += blockDim.x) {
    const int ro = __ldg(fl + 3 * f), so = __ldg(fl + 3 * f + 1);
    const int ss = __ldg(fl + 3 * f + 2);
    for (int r = 0; r < R; ++r) {
      if (r < nv) cp_async4(sm + so + r * ss, wsr + (size_t)r * rec + ro);
      else sm[so + r * ss] = 0.f;
    }
  }
  cp_async_commit();
}

// The global plan's MLP forward over `rows` rows, the weights through the
// ring: saves each hidden layer's pre-activation and post-dropout
// activation at sm + m.save_off (pre [rows, w], act [rows, w] per layer)
// and writes the output to `out`. Ends synced.
__device__ void mlp_fwd(const ScanCfg& c, const MLPDesc& m, float* sm,
                        Ring& rg, const float* x, int rows, float* out,
                        const MaskCtx& mc) {
  const float* in = x;
  float* save = sm + m.save_off;
  for (int l = 0; l < m.n_lin; ++l) {
    const LayerRec& ly = layer(c, sm, m, l);
    int wi = ly.w_in, wo = ly.w_out;
    bool last = l == m.n_lin - 1;
    float* y = last ? out : save;
    ring_op<false>(
        rg, ly.pw_off, wo, rows,
        [&](int r, int s) { return in[r * wi + s]; },
        [](int, int) { return 0.f; },
        [&](int r, int o, float v) { y[r * wo + o] = v; });
    __syncthreads();
    if (!last) {
      float* a = save + rows * wo;
      for (int idx = threadIdx.x; idx < rows * wo; idx += blockDim.x) {
        float v = act_f(ly.act, y[idx]);
        if (mc.mode) {
          int r = idx / wo, j = idx - r * wo;
          v = keep_at(mc, m.slot0 + l, r, j) ? v / mc.keep : 0.f;
        }
        a[idx] = v;
      }
      __syncthreads();
      in = a;
      save += 2 * rows * wo;
    }
  }
}

// The global plan's MLP backward: d0 [rows, out] is the gradient of the
// output; writes each Linear's output gradient (its delta) for the valid
// rows into the workspace records at wsr (put_delta), takes the weights
// through the ring and returns the buffer holding dx [rows, in] (nullptr
// unless want_dx). Ends synced.
__device__ const float* mlp_bwd(const ScanCfg& c, const MLPDesc& m,
                                float* sm, Ring& rg, float* wsr, int rows,
                                const float* d0, bool want_dx,
                                const MaskCtx& mc) {
  float* bufs[2] = {sm + c.o_dA, sm + c.o_dB};
  const float* cur = d0;
  int nb = 0;
  for (int l = m.n_lin - 1; l >= 0; --l) {
    const LayerRec& ly = layer(c, sm, m, l);
    int wi = ly.w_in, wo = ly.w_out;
    // the saved (pre, act) pair of hidden layer l - 1 (its input)
    const float* below =
        l > 0 ? sm + m.save_off + 2 * rows * layer(c, sm, m, l - 1).save
              : nullptr;
    put_delta(cur, rows, wo, mc.half, mc.nv, wsr, c.rec,
              ly.dlt + m.dhalf * wo);
    float* nxt = nullptr;
    if (l > 0 || want_dx) {
      // dx through the ring, a thread owning column i of up to RB rows
      nxt = bufs[nb];
      nb ^= 1;
      const float* pre = below;
      const int act_below = l > 0 ? layer(c, sm, m, l - 1).act : 0;
      ring_op<true>(
          rg, ly.pw_off, wi, rows,
          [&](int r, int s) { return cur[r * wo + s]; },
          [](int, int) { return 0.f; },
          [&](int r, int i, float v) {
            if (l > 0) {
              if (mc.mode)
                v = keep_at(mc, m.slot0 + l - 1, r, i) ? v / mc.keep : 0.f;
              v *= act_grad(act_below, pre[r * wi + i]);
            }
            nxt[r * wi + i] = v;
          });
    }
    __syncthreads();
    cur = nxt;
  }
  return cur;
}

// residual of class FFNN: case 1 tiles the raw input, case 2 averages its
// `mult` chunks
__device__ __forceinline__ float residual(int cs, int mult, const float* xr,
                                          int in_w, int j) {
  if (cs == 0) return 0.f;
  if (cs == 1) return xr[j % in_w];
  int chunk = in_w / mult;
  float s = xr[j];
  for (int i = 1; i < mult; ++i) s += xr[i * chunk + j];
  return s / (float)mult;
}

// gradient of the residual branch wrt the raw input column i
__device__ __forceinline__ float residual_bwd(int cs, int mult,
                                              const float* dr, int out_w,
                                              int i) {
  if (cs == 0) return 0.f;
  if (cs == 1) {
    int chunk = out_w / mult;
    float s = dr[i];
    for (int q = 1; q < mult; ++q) s += dr[q * chunk + i];
    return s;
  }
  return dr[i % out_w] / (float)mult;
}

// the layer records of the table into the CTA's region lay (read by
// every phase after the CTA's first barrier)
__device__ void load_tables(const ScanCfg& c, const int* __restrict__ tab,
                            float* sm) {
  int* lay = reinterpret_cast<int*>(sm + c.o_lay);
  for (int i = threadIdx.x; i < c.n_rec * LAYER_INTS; i += blockDim.x)
    lay[i] = __ldg(tab + i);
}

// the CTA's member's leaves, from the table's offsets and addresses (a
// member-axis launch stacks each leaf as [E, ...]: member blockIdx.y at
// blockIdx.y times the leaf's size), copied with cp.async, every copy in
// flight at once (K2's stage (a) loads them once a step); the caller
// waits for them (cp_async_wait_all) before its first barrier
__device__ void load_weights(const ScanCfg& c, const int* __restrict__ tab,
                             float* sm) {
  float* sw = sm + c.o_w;
  const int* leaf_off = tab + c.tab_leaves;
  const float* const* ptr =
      reinterpret_cast<const float* const*>(tab + c.tab_ptrs);
  for (int l = 0; l < c.n_leaves; ++l) {
    int off = __ldg(leaf_off + l), n = __ldg(leaf_off + l + 1) - off;
    const float* src = ptr[l] + (size_t)blockIdx.y * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(sw + off + i, src + i);
  }
  cp_async_commit();
}

// Member blockIdx.y's slice of a per-member tensor, `stride` elements a
// member. A member-axis launch (njode_scan_*_members) runs E members of
// one config as gridDim.y = E, every CTA offsetting its per-member
// pointers once at entry; a solo launch has gridDim.y = 1 and keeps them.
template <class T>
__device__ __forceinline__ T* member_of(T* p, size_t stride) {
  return p ? p + blockIdx.y * stride : p;
}

__device__ MaskCtx make_mask_ctx(const ScanCfg& c, float* sm,
                                 const int8_t* u, const long long* seed,
                                 int row0, int nv) {
  MaskCtx mc;
  mc.mode = c.mode;
  mc.u = u;
  unsigned long long s = (c.mode == 2) ? (unsigned long long)seed[0] : 0ull;
  mc.k0 = (uint32_t)(s & 0xFFFFFFFFull);
  mc.k1 = (uint32_t)(s >> 32);
  mc.thresh = c.thresh;
  mc.row0 = row0; mc.nv = nv; mc.half = c.rows; mc.jump = 0;
  mc.B = c.B; mc.S = c.S; mc.Wmax = c.Wmax; mc.nw = c.nw;
  mc.lg_nw = c.lg_nw; mc.skip0 = c.skip0; mc.skip1 = c.skip1;
  mc.keep = c.keep;
  mc.bits = c.mode ? mask_set(c, sm, c.rows, 0) : nullptr;
  return mc;
}

// readouts with residual: y_bj for row r (row r of h1 / the first half
// of ro), y (row R + r: h2 / the second half)
__device__ __forceinline__ float y_at(const ScanCfg& c, const float* h1,
                                      const float* h2, const float* ro,
                                      int R, int rr, int o) {
  const float* hsrc = rr < R ? h1 + rr * c.H : h2 + (rr - R) * c.H;
  return residual(c.ro_case, c.ro_mult, hsrc, c.H, o) + ro[rr * c.O + o];
}

__device__ __forceinline__ float y_at(const ScanCfg& c, const float* sm,
                                      int R, int rr, int o) {
  return y_at(c, sm + c.o_h1, sm + c.o_h2, sm + c.o_ro, R, rr, o);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The global plan's GRU jump forward (_gru_fwd) for R rows: tanh X at tX
// [R, D], h_t = tanh h1 at in_ro[0:R*H]. The gate sums run as two ring
// products, gi = W_ih x and gh = W_hh h_t (with their biases, each sum in
// index order, as res_gru_fwd sums them), into gsc [2][R, 3H]; then a
// thread owns (row r, unit j) and writes h2, tanh h2 (in_ro[R*H:]) and the
// saved (r, z, n, gh_n). Not synced at the end.
__device__ void gru_fwd(const ScanCfg& c, float* sm, Ring& rg, int R) {
  const int D = c.D, H = c.H, RH = R * H, H3 = 3 * H;
  const float* tX = sm + c.o_tX; float* in_ro = sm + c.o_in_ro;
  const float* h1 = sm + c.o_h1; float* h2 = sm + c.o_h2;
  const float* obs = sm + c.o_obs; float* sv = sm + c.o_gru;
  float* gs = sm + c.o_gsc;
  ring_op<false>(
      rg, c.gru_pwih, H3, R, [&](int r, int s) { return tX[r * D + s]; },
      [](int, int) { return 0.f; },
      [&](int r, int o, float v) { gs[r * H3 + o] = v; });
  ring_op<false>(
      rg, c.gru_pwhh, H3, R,
      [&](int r, int s) { return in_ro[r * H + s]; },
      [](int, int) { return 0.f; },
      [&](int r, int o, float v) { gs[(R + r) * H3 + o] = v; });
  __syncthreads();
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    int r = idx / H, j = idx - r * H;
    const float* ht = in_ro + r * H;
    float gi[3], gh[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi[q] = gs[r * H3 + q * H + j];
      gh[q] = gs[(R + r) * H3 + q * H + j];
    }
    float rg = sigmoid_f(gi[0] + gh[0]);
    float z = sigmoid_f(gi[1] + gh[1]);
    float n = tanhf(gi[2] + rg * gh[2]);
    float hp = (1.f - z) * n + z * ht[j];
    sv[idx] = rg;
    sv[RH + idx] = z;
    sv[2 * RH + idx] = n;
    sv[3 * RH + idx] = gh[2];
    float o = obs[r];
    float b2 = o * hp + (1.f - o) * h1[idx];
    h2[idx] = b2;
    in_ro[RH + idx] = tanhf(b2);
  }
}

// dgh of gate row gj (0..3H) at row r: da_r, da_z for r and z, dgh_n for n
__device__ __forceinline__ float dgh_at(const float* dG, int H, int r,
                                        int gj) {
  return dG[r * 4 * H + (gj < 2 * H ? gj : gj + H)];
}

// The GRU's deltas of the CTA's valid rows from dG [R, 4H] (da_r, da_z,
// da_n, dgh_n) into the workspace records at wsr: dgi = (da_r, da_z,
// da_n), the gradient of W_ih x + b_ih, and dgh = (da_r, da_z, dgh_n), of
// W_hh h_t + b_hh; idx over nv * 3H
__device__ __forceinline__ void put_gru_delta(const ScanCfg& c,
                                              const float* dG, float* wsr,
                                              int idx) {
  const int H3 = 3 * c.H, r = idx / H3, gj = idx - r * H3;
  float* q = wsr + (size_t)r * c.rec + c.dlt_gru;
  q[gj] = dG[r * 4 * c.H + gj];
  q[H3 + gj] = dgh_at(dG, c.H, r, gj);
}

// The global plan's GRU jump backward (_gru_bwd) for the CTA's nv valid
// rows of R, from dh' = dhe (obs * dh2) and the saved gates: the gate
// gradients dG, their deltas into the workspace records at wsr, and dh_t *
// (1 - h_t^2) added to dh1, then df = dt * dh1 (its W_hh product through
// the ring). Starts and ends synced.
__device__ void gru_bwd(const ScanCfg& c, float* sm, Ring& rg, float* wsr,
                        int R, int nv, float dt) {
  const int H = c.H, RH = R * H;
  const float* ht = sm + c.o_in_ro;
  const float* sv = sm + c.o_gru; float* dG = sm + c.o_dG;
  const float* dhe = sm + c.o_dhe;
  float* dh1 = sm + c.o_dh1; float* df = sm + c.o_df;
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    int r = idx / H, j = idx - r * H;
    float rg = sv[idx], z = sv[RH + idx], n = sv[2 * RH + idx];
    float d = dhe[idx];
    float da_n = d * (1.f - z) * (1.f - n * n);
    float* q = dG + r * 4 * H;
    q[j] = da_n * sv[3 * RH + idx] * rg * (1.f - rg);         // da_r
    q[H + j] = d * (ht[idx] - n) * z * (1.f - z);             // da_z
    q[2 * H + j] = da_n;                                      // dgi_n
    q[3 * H + j] = da_n * rg;                                 // dgh_n
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nv * 3 * H; idx += blockDim.x)
    put_gru_delta(c, dG, wsr, idx);
  auto dh1_out = [&](int r, int i, float acc) {
    int idx = r * H + i;
    float t = ht[idx];
    float d1 = dh1[idx] + acc * (1.f - t * t);
    dh1[idx] = d1;
    df[idx] = dt * d1;
  };
  ring_op<true>(
      rg, c.gru_pwhh, H, R,
      [&](int r, int s) { return dgh_at(dG, H, r, s); },
      [&](int r, int i) { return dhe[r * H + i] * sv[RH + r * H + i]; },
      dh1_out);
  __syncthreads();
}

// One step forward of the global plan for the CTA's rows, from the carries
// in smem (h, lx, tau, X, obs and, masked, M already loaded): fills h1,
// h2, the jump's input tX, the ODE input, the readout inputs and outputs
// (y_bj rows 0..R-1, y rows R..2R-1), with every MLP's saved activations
// (and, with use_rnn, the GRU's saved gates).
template <int RT>
__device__ void step_forward(const ScanCfg& c, float* sm, Ring& rg,
                             float t, float dt, MaskCtx& mc) {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, O = c.O;
  const int iw = c.ode.w_in;
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs;
  float* in_ode = sm + c.o_in_ode; float* tX = sm + c.o_tX;
  __syncthreads();                 // the step's carries and inputs are loaded
  for (int idx = threadIdx.x; idx < R * iw; idx += blockDim.x) {
    int r = idx / iw, q = idx - r * iw;
    float tdiff = (t - dt) - tau[r];
    float v;
    if (q < D) v = tanhf(lx[r * D + q]);
    else if (q < D + H) v = tanhf(h[r * H + q - D]);
    else if (q == D + H) v = tau[r];
    else if (q == D + H + 1) v = tdiff;
    else v = tau[r] + tdiff;                 // input_current_t feature
    in_ode[idx] = v;
  }
  if (!c.masked || c.use_rnn)      // the encoder's or the GRU's input
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
      tX[idx] = tanhf(X[idx]);
  __syncthreads();
  mc.half = R; mc.jump = 0;
  mlp_fwd(c, c.ode, sm, rg, in_ode, R, sm + c.o_f, mc);
  float* f = sm + c.o_f; float* enc = sm + c.o_enc;
  float* h1 = sm + c.o_h1; float* h2 = sm + c.o_h2;
  float* in_ro = sm + c.o_in_ro;
  if (c.masked && !c.use_rnn) {
    const float* M = sm + c.o_M;
    float* Xi = sm + c.o_Xi;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      float a = h[idx] + dt * f[idx];
      h1[idx] = a;
      in_ro[idx] = tanhf(a);
    }
    __syncthreads();
    mlp_fwd(c, c.ro, sm, rg, in_ro, R, sm + c.o_ro, mc);  // y_bj, r1
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D, q = idx - r * D;
      float m = M[idx];
      float xi = X[idx] * m + (1.f - m) * y_at(c, sm, R, r, q);
      Xi[idx] = xi;
      tX[r * 2 * D + q] = tanhf(xi);
      tX[r * 2 * D + D + q] = m;
    }
    __syncthreads();
    mlp_fwd(c, c.enc, sm, rg, tX, R, enc, mc);
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float he = residual(c.enc_case, c.enc_mult, Xi + r * D, D, j)
                 + enc[idx];
      float o = obs[r];
      float b = o * he + (1.f - o) * h1[idx];
      h2[idx] = b;
      in_ro[R * H + idx] = tanhf(b);
    }
    __syncthreads();
    mlp_fwd(c, c.ro2, sm, rg, in_ro + R * H, R, sm + c.o_ro + R * O,
                mc);
    mc.half = 2 * R;
    return;
  }
  if (c.use_rnn) {
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      float a = h[idx] + dt * f[idx];
      h1[idx] = a;
      in_ro[idx] = tanhf(a);
    }
    __syncthreads();
    gru_fwd(c, sm, rg, R);
  } else {
    mlp_fwd(c, c.enc, sm, rg, tX, R, enc, mc);
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float a = h[idx] + dt * f[idx];
      float he = residual(c.enc_case, c.enc_mult, X + r * D, D, j)
                 + enc[idx];
      float o = obs[r];
      float b = o * he + (1.f - o) * a;
      h1[idx] = a;
      h2[idx] = b;
      in_ro[idx] = tanhf(a);
      in_ro[R * H + idx] = tanhf(b);
    }
  }
  __syncthreads();
  mc.half = R; mc.jump = c.ro.n_lin - 1;   // rows >= R use the r2 slots
  mlp_fwd(c, c.ro, sm, rg, in_ro, 2 * R, sm + c.o_ro, mc);
  mc.half = 2 * R;                          // no stacked rows elsewhere
}

// the error terms of output o of a row (m d1^2, m d2^2) from y_bj = yb and
// y: the masked coordinates (M) count only where observed
__device__ __forceinline__ void out_errors(const ScanCfg& c, float yb,
                                           float y, float x, float m,
                                           float& t1, float& t2) {
  float d1 = x - y, d2 = yb - (c.easy ? x : y);
  t1 = m * d1 * d1;
  t2 = m * d2 * d2;
}

// The loss where the output's width O differs from the input's D
// (unmasked, one of them 1; the global plan only, so the resident kernels'
// code is the D == O code alone): as the eager forward's step loss, whose
// coordinate mask M = ones_like(X) broadcasts with y, y_bj [B, O], a row
// has NE = max(D, O) coordinates, coordinate e reading X at x_of(e) and y,
// y_bj at y_of(e), and both terms sum over all NE of them. Out of line,
// one row's pointers and sizes by value (Bcast), so that the global
// kernels' code for D == O stays as it was.
struct Bcast {
  const float *h1, *h2, *rb, *r;   // the row's h1, h2 [H]; readout outputs
                                   // before the residual, y_bj's and y's [O]
  const float* x;                  // the row's X [D]
  int D, O, H, ro_case, ro_mult, easy;
};

__device__ __forceinline__ Bcast bcast_row(const ScanCfg& c, const float* h1,
                                           const float* h2, const float* ro,
                                           const float* X, int R, int r) {
  return Bcast{h1 + r * c.H, h2 + r * c.H, ro + r * c.O, ro + (R + r) * c.O,
               X + r * c.D, c.D, c.O, c.H, c.ro_case, c.ro_mult, c.easy};
}

// y_bj and y at coordinate e (residual included), and X's value there
__device__ __forceinline__ void bcast_at(const Bcast& b, int e, float& yb,
                                         float& y, float& x) {
  const int o = b.O == 1 ? 0 : e;
  yb = residual(b.ro_case, b.ro_mult, b.h1, b.H, o) + b.rb[o];
  y = residual(b.ro_case, b.ro_mult, b.h2, b.H, o) + b.r[o];
  x = b.x[b.D == 1 ? 0 : e];
}

// the row's sums of both terms over its coordinates, in coordinate order
__device__ __noinline__ float2 bcast_sums(Bcast b) {
  float e1 = 0.f, e2 = 0.f;
  for (int e = 0; e < max(b.D, b.O); ++e) {
    float yb, y, x;
    bcast_at(b, e, yb, y, x);
    const float d1 = x - y, d2 = yb - (b.easy ? x : y);
    e1 += d1 * d1;
    e2 += d2 * d2;
  }
  return make_float2(e1, e2);
}

// output o's gradients (dy, dyb) from the row's (de1, de2), summed over its
// coordinates (the broadcast axis)
__device__ __noinline__ float2 bcast_grads(Bcast b, int o, float de1,
                                           float de2) {
  const int NE = max(b.D, b.O);
  const int e0 = b.O == NE ? o : 0, e1 = b.O == NE ? o + 1 : NE;
  float dy = 0.f, dyb = 0.f;
  for (int e = e0; e < e1; ++e) {
    float yb, y, x;
    bcast_at(b, e, yb, y, x);
    float ty = de1 * 2.f * (y - x);
    const float tyb = de2 * 2.f * (yb - (b.easy ? x : y));
    if (!b.easy) ty += de2 * 2.f * (y - yb);
    dy = e == e0 ? ty : dy + ty;
    dyb = e == e0 ? tyb : dyb + tyb;
  }
  return make_float2(dy, dyb);
}

// the row's two error norms and its loss factor g from the sums e1, e2 of
// its outputs' error terms
__device__ __forceinline__ void row_norms(const ScanCfg& c, float e1,
                                          float e2, float& s1, float& s2,
                                          float& g) {
  s1 = sqrtf(e1 + 1e-10f);
  s2 = sqrtf(e2 + 1e-10f);
  float fac = c.easy ? 1.f : 2.f;
  g = fac * c.weight * s1 + fac * (1.f - c.weight) * s2;
}

// the step's loss gradients wrt (e1, e2) per row, or its loss term
__device__ __forceinline__ void row_errors(const ScanCfg& c,
                                           const float* sm, int R, int r,
                                           float& s1, float& s2, float& g) {
  const int D = c.D;
  const float* X = sm + c.o_X;
  const float* M = sm + c.o_M;
  float e1 = 0.f, e2 = 0.f;
  if (c.D == c.O) {
    for (int o = 0; o < c.O; ++o) {
      float t1, t2;
      out_errors(c, y_at(c, sm, R, r, o), y_at(c, sm, R, R + r, o),
                 X[r * D + o], c.masked ? M[r * D + o] : 1.f, t1, t2);
      e1 += t1;
      e2 += t2;
    }
  } else {                         // unmasked: the loss broadcast
    const float2 t = bcast_sums(bcast_row(c, sm + c.o_h1, sm + c.o_h2,
                                          sm + c.o_ro, X, R, r));
    e1 = t.x;
    e2 = t.y;
  }
  row_norms(c, e1, e2, s1, s2, g);
}

// ----------------------------------------------------- the resident plan
//
// K1-K3 with every weight in shared memory, one CTA of R rows (at the
// training batches, R = 1: Spec.rows_for). A step is a short list of
// phases, one __syncthreads each; in a phase every thread takes items of
// an index space that holds all the work that reads only what the phases
// before it wrote:
//   - a hidden layer's item (r, j) sums y[r, j] (one FMA chain over the
//     summed index, upwards, as the global plan sums it) and writes the
//     pre-activation and the post-dropout activation at once;
//   - independent nets share their phases: the ODE net and the encoder on
//     the unmasked encoder jump, forward (hidden layers aligned at their
//     ends) and backward (aligned at their tops);
//   - a net's last layer is fused with what reads its output (the Euler
//     step, the jump, the imputation, the carries' gradients), a thread
//     summing each output it needs (two chains side by side where a row's
//     item needs two);
//   - a backward phase holds a layer's dx items, its weight and bias
//     gradients, and the other net's;
//   - the step's inputs (t, dt, X, obs, M; K2 also the stored carries) are
//     copied with cp.async into the other of two io sets during the first
//     phase of the step before the one that reads them, and the ODE's and
//     the jump's inputs of that step (tanh of the carries, the time
//     features, tanh X) are built in the last phase of the step before.
// So a K1 step on the unmasked encoder jump runs 7 phases (a layer a
// phase, activations apart: about 19), K2 13 (about 32); masked 13 and
// 25, with the GRU jump 8 and 15. Each output keeps its sum and the expressions around it,
// so at one R the resident and the global plan give the same bits.

// The end of a phase: a barrier. Built with -DNJODE_PHASE_CLOCK
// (ab_scan_kernels.py's `phases`), thread 0 of CTA 0 also records the SM's
// clock after it, over one step (the middle one) of each launch, for
// njode_phase_clock to read.
#ifdef NJODE_PHASE_CLOCK
__device__ long long g_phase_clk[256];
__device__ int g_phase_n, g_phase_on;

__device__ __forceinline__ void phase_clock_step(int k, int K) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    g_phase_on = k == K / 2;
    if (g_phase_on) {
      g_phase_n = 1;
      g_phase_clk[0] = clock64();
    }
  }
}

__device__ __forceinline__ void phase_end() {
  __syncthreads();
  if (threadIdx.x == 0 && blockIdx.x == 0 && g_phase_on && g_phase_n < 256)
    g_phase_clk[g_phase_n++] = clock64();
}
#else
__device__ __forceinline__ void phase_clock_step(int, int) {}
__device__ __forceinline__ void phase_end() { __syncthreads(); }
#endif

// one io set: a step's inputs and carries (Spec.layout's io; two sets,
// c.io_stride floats apart)
struct IO {
  float *tdt, *h, *lx, *tau, *X, *obs, *M, *in_ode, *tX;
};

__device__ __forceinline__ IO io_set(const ScanCfg& c, float* sm, int p) {
  float* b = sm + (p & 1) * c.io_stride;
  return IO{b + c.o_tdt, b + c.o_h, b + c.o_lx, b + c.o_tau, b + c.o_X,
            b + c.o_obs, b + c.o_M, b + c.o_in_ode, b + c.o_tX};
}

// sum_i x[i] w[i], one FMA chain upwards, then + *b (the loads of eight
// links issued ahead of their FMAs)
__device__ __forceinline__ float dot_up(const float* x, const float* w,
                                        int n, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc = fmaf(x[i], w[i], acc);
  return b ? acc + *b : acc;
}

// sum_j d[j] W[j, i] (column i of the dx product, W [out, in]) upwards
__device__ __forceinline__ float dot_col(const float* d, const float* W,
                                         int out, int in, int i) {
  float acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < out; ++j) acc = fmaf(d[j], W[j * in + i], acc);
  return acc;
}

// the same column against two rows of d, the chains side by side
__device__ __forceinline__ void dot_col2(const float* d1, const float* d2,
                                         const float* W, int out, int in,
                                         int i, float& a, float& b) {
  float x = 0.f, y = 0.f;
#pragma unroll 8
  for (int j = 0; j < out; ++j) {
    float w = W[j * in + i];
    x = fmaf(d1[j], w, x);
    y = fmaf(d2[j], w, y);
  }
  a = x;
  b = y;
}

__device__ __forceinline__ bool keep_hj(const MaskCtx& mc, int slot,
                                        int half, int jump, int r, int col) {
  MaskCtx m = mc;
  m.half = half;
  m.jump = jump;
  return keep_at(m, slot, r, col);
}

// Linear l of MLP m over `rows` rows from x0 (its input at l = 0): weights,
// input (the saved activation of layer l - 1), and where a hidden layer
// saves its pre-activation and post-dropout activation (fo floats past the
// layout's saves: the resident chain's io set of the step); half / jump:
// the stacked rows' dropout slots (keep_at)
struct Lin {
  const float* W;
  const float* b;
  const float* x;
  float* pre;
  float* act;
  int in, out, rows, actf, slot, half, jump;
};

__device__ Lin lin_of(const ScanCfg& c, const MLPDesc& m, float* sm,
                      const float* x0, int rows, int l, int half, int jump,
                      int fo) {
  const float* sw = sm + c.o_w;
  const LayerRec& ly = layer(c, sm, m, l);
  const int s = fo + m.save_off + 2 * rows * ly.save;
  Lin L;
  L.W = sw + ly.w_off;
  L.b = ly.b_off >= 0 ? sw + ly.b_off : nullptr;
  L.x = l == 0 ? x0 : sm + s - rows * ly.w_in;
  L.pre = sm + s;
  L.act = sm + s + rows * ly.w_out;
  L.in = ly.w_in;
  L.out = ly.w_out;
  L.rows = rows;
  L.actf = l + 1 < m.n_lin ? ly.act : 0;
  L.slot = m.slot0 + l;
  L.half = half;
  L.jump = jump;
  return L;
}

// output j of row r of a Linear (bias included)
__device__ __forceinline__ float lin_out(const Lin& L, int r, int j) {
  return dot_up(L.x + r * L.in, L.W + j * L.in, L.in,
                L.b ? L.b + j : nullptr);
}

// outputs j of row r of two Linears, the chains side by side
__device__ __forceinline__ void lin_out2(const Lin& A, const Lin& B, int r,
                                         int j, float& fa, float& fb) {
  const float* xa = A.x + r * A.in;
  const float* wa = A.W + j * A.in;
  const float* xb = B.x + r * B.in;
  const float* wb = B.W + j * B.in;
  const int n = min(A.in, B.in);
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int i = 0; i < n; ++i) {
    a = fmaf(xa[i], wa[i], a);
    b = fmaf(xb[i], wb[i], b);
  }
  for (int i = n; i < A.in; ++i) a = fmaf(xa[i], wa[i], a);
  for (int i = n; i < B.in; ++i) b = fmaf(xb[i], wb[i], b);
  fa = A.b ? a + A.b[j] : a;
  fb = B.b ? b + B.b[j] : b;
}

// output j of rows ra and rb of a Linear, the chains side by side
__device__ __forceinline__ void lin_out_rows2(const Lin& L, int ra, int rb,
                                              int j, float& fa, float& fb) {
  const float* xa = L.x + ra * L.in;
  const float* xb = L.x + rb * L.in;
  const float* w = L.W + j * L.in;
  float a = 0.f, b = 0.f;
#pragma unroll 8
  for (int i = 0; i < L.in; ++i) {
    a = fmaf(xa[i], w[i], a);
    b = fmaf(xb[i], w[i], b);
  }
  fa = L.b ? a + L.b[j] : a;
  fb = L.b ? b + L.b[j] : b;
}

// hidden item idx = (r, j): the pre-activation, then the activation and
// its dropout, both saved
__device__ __forceinline__ void hidden_item(const Lin& L, int idx,
                                            const MaskCtx& mc) {
  int r = idx / L.out, j = idx - r * L.out;
  // the mask bit first, off the item's chain
  const bool kp = !mc.mode || keep_hj(mc, L.slot, L.half, L.jump, r, j);
  float v = lin_out(L, r, j);
  L.pre[idx] = v;
  float a = act_f(L.actf, v);
  if (mc.mode) a = kp ? a / mc.keep : 0.f;
  L.act[idx] = a;
}

// an MLP run by a step: its description, input, rows and stacking, and
// where its saves lie (lin_of's fo)
struct Net {
  const MLPDesc* m;
  const float* x;
  int rows, half, jump;
  int fo;
};

__device__ __forceinline__ Lin net_lin(const ScanCfg& c, float* sm,
                                       const Net& n, int l) {
  return lin_of(c, *n.m, sm, n.x, n.rows, l, n.half, n.jump, n.fo);
}

// The hidden layers of net a and of net b (b.m null: none), aligned at
// their ends, a phase each (the first with lanes of f, where not null);
// ends synced. The caller runs the last layers.
__device__ void hidden_phases(const ScanCfg& c, float* sm, const Net& a,
                              const Net& b, const MaskCtx& mc,
                              Fill* f = nullptr) {
  const int ha = a.m->n_lin - 1, hb = b.m ? b.m->n_lin - 1 : 0;
  const int hm = max(ha, hb);
  for (int p = 0; p < hm; ++p) {
    const int la = p - (hm - ha), lb = p - (hm - hb);
    Lin A = {}, Bl = {};
    int na = 0, nb = 0;
    if (la >= 0) {
      A = net_lin(c, sm, a, la);
      na = A.rows * A.out;
    }
    if (b.m && lb >= 0) {
      Bl = net_lin(c, sm, b, lb);
      nb = Bl.rows * Bl.out;
    }
    items_fill(mc, p == 0 ? f : nullptr, na + nb, false, [&](int idx) {
      if (idx < na) hidden_item(A, idx, mc);
      else hidden_item(Bl, idx - na, mc);
    });
    phase_end();
  }
}

// the GRU jump forward (gru_fwd's resident form: a thread owns (row r, unit
// j) and all three gates' sums) from tanh X at io.tX and h_t = tanh h1 at
// in_ro[0:R*H]; writes h2, tanh h2 and the saved (r, z, n, gh_n)
__device__ void res_gru_fwd(const ScanCfg& c, float* sm, const IO& io,
                            int R) {
  const int D = c.D, H = c.H, RH = R * H;
  const float* sw = sm + c.o_w;
  float* in_ro = sm + c.o_in_ro;
  const float* h1 = sm + c.o_h1;
  float* h2 = sm + c.o_h2;
  float* sv = sm + c.o_gru;
  for (int idx = threadIdx.x; idx < RH; idx += NTHREADS) {
    int r = idx / H, j = idx - r * H;
    const float* x = io.tX + r * D;
    const float* ht = in_ro + r * H;
    float gi[3], gh[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* wi = sw + c.gru_wih + (size_t)(q * H + j) * D;
      const float* wh = sw + c.gru_whh + (size_t)(q * H + j) * H;
      float a = 0.f, b = 0.f;
      for (int i = 0; i < D; ++i) a = fmaf(x[i], wi[i], a);
      for (int i = 0; i < H; ++i) b = fmaf(ht[i], wh[i], b);
      if (c.gru_bih >= 0) {
        a += sw[c.gru_bih + q * H + j];
        b += sw[c.gru_bhh + q * H + j];
      }
      gi[q] = a;
      gh[q] = b;
    }
    float rg = sigmoid_f(gi[0] + gh[0]);
    float z = sigmoid_f(gi[1] + gh[1]);
    float n = tanhf(gi[2] + rg * gh[2]);
    float hp = (1.f - z) * n + z * ht[j];
    sv[idx] = rg;
    sv[RH + idx] = z;
    sv[2 * RH + idx] = n;
    sv[3 * RH + idx] = gh[2];
    float o = io.obs[r];
    float b2 = o * hp + (1.f - o) * h1[idx];
    h2[idx] = b2;
    in_ro[RH + idx] = tanhf(b2);
  }
}

// the loss's error terms of output o of row r (region le: [R, O] of
// m d1^2, then [R, O] of m d2^2) from the readouts' outputs vb (y_bj) and
// v (y) before their residuals; row_sums adds them up in output order
__device__ __forceinline__ void loss_terms(const ScanCfg& c, float* sm,
                                           int R, const IO& io, int r, int o,
                                           float vb, float v) {
  const int H = c.H, idx = r * c.O + o;
  float t1, t2;
  out_errors(c,
             residual(c.ro_case, c.ro_mult, sm + c.o_h1 + r * H, H, o) + vb,
             residual(c.ro_case, c.ro_mult, sm + c.o_h2 + r * H, H, o) + v,
             io.X[r * c.D + o], c.masked ? io.M[r * c.D + o] : 1.f, t1, t2);
  sm[c.o_le + idx] = t1;
  sm[c.o_le + R * c.O + idx] = t2;
}

// row r's error norms and loss factor (row_errors) from its outputs' terms
// in region le, added in output order
__device__ __forceinline__ void row_sums(const ScanCfg& c, const float* sm,
                                         int R, int r, float& s1, float& s2,
                                         float& g) {
  const float* le = sm + c.o_le + r * c.O;
  float e1 = 0.f, e2 = 0.f;
  for (int o = 0; o < c.O; ++o) {
    e1 += le[o];
    e2 += le[R * c.O + o];
  }
  row_norms(c, e1, e2, s1, s2, g);
}

// One step forward from io set `io` (its in_ode, tX, h, X, obs, M, t, dt
// in place and synced): h1, h2, tanh of both (in_ro), the readouts' outputs
// ro (y_bj rows 0..R-1, y rows R..2R-1), every MLP's saved activations and
// the GRU's saved gates; its first phase takes lanes of f. The last phase
// (the readout's last layer) is left open: the caller ends it.
__device__ void res_step_forward(const ScanCfg& c, float* sm, int R,
                                 const IO& io, const MaskCtx& mc, Fill& f) {
  const int D = c.D, H = c.H, O = c.O, RH = R * H;
  const float dt = io.tdt[1];
  float* h1 = sm + c.o_h1;
  float* h2 = sm + c.o_h2;
  float* in_ro = sm + c.o_in_ro;
  float* ro = sm + c.o_ro;
  const Net none{nullptr, nullptr, 0, 0, 0, 0};
  const Net ode{&c.ode, io.in_ode, R, R, 0, 0};
  if (!c.masked && !c.use_rnn) {
    // the ODE net and the encoder side by side, the Euler step and the
    // jump in the phase of their last layers
    const Net enc{&c.enc, io.tX, R, R, 0, 0};
    hidden_phases(c, sm, ode, enc, mc, &f);
    const Lin F = net_lin(c, sm, ode, c.ode.n_lin - 1);
    const Lin E = net_lin(c, sm, enc, c.enc.n_lin - 1);
    for (int idx = threadIdx.x; idx < RH; idx += NTHREADS) {
      int r = idx / H, j = idx - r * H;
      float f, e;
      lin_out2(F, E, r, j, f, e);
      float a = io.h[idx] + dt * f;
      float he = residual(c.enc_case, c.enc_mult, io.X + r * D, D, j) + e;
      float o = io.obs[r];
      float b = o * he + (1.f - o) * a;
      h1[idx] = a;
      h2[idx] = b;
      in_ro[idx] = tanhf(a);
      in_ro[RH + idx] = tanhf(b);
    }
    phase_end();
  } else {
    hidden_phases(c, sm, ode, none, mc, &f);
    const Lin F = net_lin(c, sm, ode, c.ode.n_lin - 1);
    for (int idx = threadIdx.x; idx < RH; idx += NTHREADS) {
      int r = idx / H, j = idx - r * H;
      float a = io.h[idx] + dt * lin_out(F, r, j);
      h1[idx] = a;
      in_ro[idx] = tanhf(a);
    }
    phase_end();
    if (c.use_rnn) {
      res_gru_fwd(c, sm, io, R);
      phase_end();
    } else {
      // masked: the pre-jump readout imputes the unobserved coordinates
      // in the phase of its last layer (O == D), the encoder reads
      // [tanh X_imp, M], the post-jump readout runs on its own
      const Net r1{&c.ro, in_ro, R, R, 0, 0};
      hidden_phases(c, sm, r1, none, mc);
      const Lin G = net_lin(c, sm, r1, c.ro.n_lin - 1);
      float* Xi = sm + c.o_Xi;
      for (int idx = threadIdx.x; idx < R * O; idx += NTHREADS) {
        int r = idx / O, q = idx - r * O;
        float v = lin_out(G, r, q);
        ro[idx] = v;
        float y = residual(c.ro_case, c.ro_mult, h1 + r * H, H, q) + v;
        float m = io.M[idx];
        float xi = io.X[idx] * m + (1.f - m) * y;
        Xi[idx] = xi;
        io.tX[r * 2 * D + q] = tanhf(xi);
        io.tX[r * 2 * D + D + q] = m;
      }
      phase_end();
      const Net enc{&c.enc, io.tX, R, R, 0, 0};
      hidden_phases(c, sm, enc, none, mc);
      const Lin E = net_lin(c, sm, enc, c.enc.n_lin - 1);
      for (int idx = threadIdx.x; idx < RH; idx += NTHREADS) {
        int r = idx / H, j = idx - r * H;
        float he = residual(c.enc_case, c.enc_mult, Xi + r * D, D, j)
                   + lin_out(E, r, j);
        float o = io.obs[r];
        float b = o * he + (1.f - o) * h1[idx];
        h2[idx] = b;
        in_ro[RH + idx] = tanhf(b);
      }
      phase_end();
      const Net r2{&c.ro2, in_ro + RH, R, R, 0, 0};
      hidden_phases(c, sm, r2, none, mc);
      const Lin G2 = net_lin(c, sm, r2, c.ro2.n_lin - 1);
      for (int idx = threadIdx.x; idx < R * O; idx += NTHREADS) {
        const int r = idx / O, o = idx - r * O;
        const float v = lin_out(G2, r, o);
        ro[R * O + idx] = v;
        loss_terms(c, sm, R, io, r, o, ro[idx], v);
      }
      return;
    }
  }
  // both readouts as one stacked pass of 2R rows (rows >= R: the r2 slots);
  // the last layer's thread of (row r, output o) sums both stacked rows'
  // (y_bj and y) side by side
  const Net rs{&c.ro, in_ro, 2 * R, R, c.ro.n_lin - 1, 0};
  hidden_phases(c, sm, rs, none, mc);
  const Lin G = net_lin(c, sm, rs, c.ro.n_lin - 1);
  for (int idx = threadIdx.x; idx < R * O; idx += NTHREADS) {
    const int r = idx / O, o = idx - r * O;
    float vb, v;
    lin_out_rows2(G, r, R + r, o, vb, v);
    ro[idx] = vb;
    ro[R * O + idx] = v;
    loss_terms(c, sm, R, io, r, o, vb, v);
  }
}

// Start copying step k's inputs into io set s (rows past nv: zeros): t,
// dt, X, obs, M and, with hh (K2), the stored carries h, last_X, tau.
__device__ void stage_inputs(const ScanCfg& c, const IO& s, int k, int row0,
                             int nv, int R, const float* times,
                             const float* dts, const float* obs_g,
                             const float* X_g, const float* M_g,
                             const float* hh, const float* lxh,
                             const float* tauh) {
  const int D = c.D, H = c.H;
  const size_t kb = (size_t)k * c.B + row0;
  if (threadIdx.x == 0) {
    cp_async4(s.tdt, times + k);
    cp_async4(s.tdt + 1, dts + k);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    bool ok = r < nv;
    if (ok) cp_async4(s.obs + r, obs_g + kb + r);
    else s.obs[r] = 0.f;
    if (hh) {
      if (ok) cp_async4(s.tau + r, tauh + kb + r);
      else s.tau[r] = 0.f;
    }
  }
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    bool ok = idx / D < nv;
    size_t gi = kb * D + idx;
    if (ok) cp_async4(s.X + idx, X_g + gi);
    else s.X[idx] = 0.f;
    if (c.masked) {
      if (ok) cp_async4(s.M + idx, M_g + gi);
      else s.M[idx] = 0.f;
    }
    if (hh) {
      if (ok) cp_async4(s.lx + idx, lxh + gi);
      else s.lx[idx] = 0.f;
    }
  }
  if (hh)
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      if (idx / H < nv) cp_async4(s.h + idx, hh + kb * H + idx);
      else s.h[idx] = 0.f;
    }
  cp_async_commit();
}

// items of build_item: the ODE's input [tanh last_X, tanh h, tau, tdiff
// (, t_prev)] and the jump's tanh X (unmasked or GRU)
__device__ __forceinline__ int n_build(const ScanCfg& c, int R) {
  return R * c.ode.w_in + (!c.masked || c.use_rnn ? R * c.D : 0);
}

__device__ __forceinline__ void build_item(const ScanCfg& c, const IO& s,
                                           int R, int e) {
  const int D = c.D, H = c.H, iw = c.ode.w_in;
  if (e < R * iw) {
    int r = e / iw, q = e - r * iw;
    float tdiff = (s.tdt[0] - s.tdt[1]) - s.tau[r];
    float v;
    if (q < D) v = tanhf(s.lx[r * D + q]);
    else if (q < D + H) v = tanhf(s.h[r * H + q - D]);
    else if (q == D + H) v = s.tau[r];
    else if (q == D + H + 1) v = tdiff;
    else v = s.tau[r] + tdiff;             // input_current_t feature
    s.in_ode[e] = v;
  } else {
    e -= R * iw;
    s.tX[e] = tanhf(s.X[e]);
  }
}

// K1/K3's last phase of step k: each row's loss term, the carries after the
// step (tau, last_X, h; masked: last_X takes the post-jump prediction) into
// io set nx, with their histories, and from them and nx's t, dt and X (in
// place since the phase before) the next step's in_ode and tX; and the
// lanes of f the phases before left
template <bool WANT_HISTS>
__device__ void res_carry(const ScanCfg& c, float* sm, int R, const IO& cu,
                          const IO& nx, int k, int row0, int nv, float* hh,
                          float* lxh, float* tauh, const MaskCtx& mc,
                          Fill& f) {
  const int D = c.D, H = c.H, iw = c.ode.w_in;
  const size_t kb = (size_t)(k + 1) * c.B + row0;
  const bool hist = WANT_HISTS && k + 1 < c.K;
  const float t = cu.tdt[0], t1 = nx.tdt[0], dt1 = nx.tdt[1];
  const float* h1 = sm + c.o_h1;
  const float* h2 = sm + c.o_h2;
  const float* ro = sm + c.o_ro;
  const float* nobs = sm + c.o_nobs;
  float* lrow = sm + c.o_lrow;
  const int n_x = !c.masked || c.use_rnn ? R * D : 0;
  const int n = R + R * D + R * H + n_x;
  items_fill(mc, &f, n, true, [&](int e) {
    int q = e;
    if (q < R) {
      const int r = q;
      float s1, s2, g;
      row_sums(c, sm, R, r, s1, s2, g);
      const float o = cu.obs[r];
      lrow[r] += o * g * g / fmaxf(nobs[r], 1.f);
      const float ta = o > 0.f ? t : cu.tau[r];
      nx.tau[r] = ta;
      const float tdiff = (t1 - dt1) - ta;
      float* in = nx.in_ode + r * iw;
      in[D + H] = ta;
      in[D + H + 1] = tdiff;
      if (c.ict) in[D + H + 2] = ta + tdiff;
      if (hist && r < nv) tauh[kb + r] = ta;
      return;
    }
    q -= R;
    if (q < R * D) {
      const int r = q / D, i = q - r * D;
      float v = cu.lx[q];
      if (cu.obs[r] > 0.f)
        v = c.masked ? y_at(c, h1, h2, ro, R, R + r, i) : cu.X[q];
      nx.lx[q] = v;
      nx.in_ode[r * iw + i] = tanhf(v);
      if (hist && r < nv) lxh[kb * D + q] = v;
      return;
    }
    q -= R * D;
    if (q < R * H) {
      const int r = q / H, j = q - r * H;
      const float v = h2[q];
      nx.h[q] = v;
      nx.in_ode[r * iw + D + j] = tanhf(v);
      if (hist && r < nv) hh[kb * H + q] = v;
      return;
    }
    q -= R * H;
    nx.tX[q] = tanhf(nx.X[q]);
  });
}

// K2's chain: each row's loss gradients into dst = [dy_bj ; dy] (masked:
// M weighs each coordinate, and last_X2 = where(obs, y, last_X) adds obs *
// dlast_X to dy; a thread of (row, output) computes its row's error
// terms), and the carries' gradients past an observation (dlxc, dtauc);
// the step's forward values (h1, h2, ro, le) at fs, its io set
__device__ void res_loss_grads(const ScanCfg& c, float* sm, const float* fs,
                               int R, const IO& cu, float dloss) {
  const int D = c.D, O = c.O;
  const float* h1 = fs + c.o_h1;
  const float* h2 = fs + c.o_h2;
  const float* ro = fs + c.o_ro;
  const float* nobs = sm + c.o_nobs;
  const float* dlx = sm + c.o_dlx;
  const float* dtau = sm + c.o_dtau;
  float* dst = sm + c.o_dst;
  float* dlxc = sm + c.o_dlxc;
  float* dtauc = sm + c.o_dtauc;
  const int n = R * O + R * D + R;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int q = e;
    if (q < R * O) {
      const int r = q / O, o = q - r * O;
      float s1, s2, gg;
      row_sums(c, fs, R, r, s1, s2, gg);
      float fac = c.easy ? 1.f : 2.f;
      float dinner = dloss * cu.obs[r] / fmaxf(nobs[r], 1.f) / (float)c.B;
      float dg = 2.f * gg * dinner;
      float rs0 = (fac * c.weight * dg) * (0.5f / s1);
      float rs1 = (fac * (1.f - c.weight) * dg) * (0.5f / s2);
      float yb = y_at(c, h1, h2, ro, R, r, o);
      float y = y_at(c, h1, h2, ro, R, R + r, o);
      float x = cu.X[r * D + o];
      float m = c.masked ? cu.M[r * D + o] : 1.f;
      float de1 = rs0 * m, de2 = rs1 * m;
      float dy = de1 * 2.f * (y - x);
      float dyb = de2 * 2.f * (yb - (c.easy ? x : y));
      if (!c.easy) dy += de2 * 2.f * (y - yb);
      if (c.masked) dy += cu.obs[r] * dlx[r * D + o];
      dst[q] = dyb;
      dst[R * O + q] = dy;
      continue;
    }
    q -= R * O;
    if (q < R * D) {
      dlxc[q] = (1.f - cu.obs[q / D]) * dlx[q];
      continue;
    }
    q -= R * D;
    dtauc[q] = (1.f - cu.obs[q]) * dtau[q];
  }
}

// The backward of Linear l of an MLP over `rows` rows: d [rows, out], the
// gradient of its output, which it writes for the valid rows to the
// workspace records at wsr (record offset dlt; put_delta), and, where dx
// is set (a hidden layer below), dx [rows, in] through the layer below's
// dropout and activation (pre: its saved pre-activation)
struct BLin {
  const float* W;
  const float* d;
  float* dx;
  const float* pre;
  float* wsr;
  int in, out, rows, actf, slot, half, jump, nv, rec, dlt;
};

__device__ BLin blin_of(const ScanCfg& c, float* sm, const Net& n, int l,
                        const float* d, float* dx, int nv, float* wsr) {
  const MLPDesc& m = *n.m;
  const Lin L = net_lin(c, sm, n, l);
  const LayerRec& ly = layer(c, sm, m, l);
  BLin b;
  b.W = L.W;
  b.d = d;
  b.dx = l > 0 ? dx : nullptr;
  b.pre = l > 0 ? L.x - n.rows * ly.w_in : nullptr;
  b.wsr = wsr;
  b.in = L.in;
  b.out = L.out;
  b.rows = n.rows;
  b.actf = l > 0 ? layer(c, sm, m, l - 1).act : 0;
  b.slot = m.slot0 + l - 1;
  b.half = n.half;
  b.jump = n.jump;
  b.nv = nv;
  b.rec = c.rec;
  b.dlt = ly.dlt + m.dhalf * ly.w_out;
  return b;
}

__device__ __forceinline__ void dx_item(const BLin& L, int idx,
                                        const MaskCtx& mc) {
  const int r = idx / L.in, i = idx - r * L.in;
  const bool kp = !mc.mode || keep_hj(mc, L.slot, L.half, L.jump, r, i);
  float acc = dot_col(L.d + r * L.out, L.W, L.out, L.in, i);
  if (mc.mode) acc = kp ? acc / mc.keep : 0.f;
  acc *= act_grad(L.actf, L.pre[idx]);
  L.dx[idx] = acc;
}

// One backward phase: n_c items of `cust` first (a last layer's dx fused
// with what reads it), then the dx items of A and B (where they have a
// hidden layer below), then their deltas into the workspace (A or B null:
// none); with `last`, the step's last phase, it first waits for the next
// step's copies; ends synced.
template <class C>
__device__ __forceinline__ void bwd_phase(const BLin* A, const BLin* B,
                                          int n_c, const C& cust,
                                          const MaskCtx& mc,
                                          bool last = false) {
  const int xa = A && A->dx ? A->rows * A->in : 0;
  const int xb = B && B->dx ? B->rows * B->in : 0;
  const int n = n_c + xa + xb;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int q = e;
    if (q < n_c) { cust(q); continue; }
    q -= n_c;
    if (q < xa) dx_item(*A, q, mc);
    else dx_item(*B, q - xa, mc);
  }
  if (A) put_delta(A->d, A->rows, A->out, A->half, A->nv, A->wsr, A->rec,
                  A->dlt);
  if (B) put_delta(B->d, B->rows, B->out, B->half, B->nv, B->wsr, B->rec,
                  B->dlt);
  if (last) cp_async_wait_all();
  phase_end();
}

// The backward of net n's layers n_lin-1 .. 1, a phase each, from d0, the
// gradient of its output, through the buffers b0, b1 in turn; returns the
// gradient of layer 0's output.
__device__ const float* bwd_upper(const ScanCfg& c, float* sm, const Net& n,
                                  const float* d0, float* b0, float* b1,
                                  int nv, float* wsr, const MaskCtx& mc) {
  const float* cur = d0;
  float* bufs[2] = {b0, b1};
  int nb = 0;
  for (int l = n.m->n_lin - 1; l >= 1; --l) {
    const BLin L = blin_of(c, sm, n, l, cur, bufs[nb], nv, wsr);
    bwd_phase(&L, nullptr, 0, [](int) {}, mc);
    cur = bufs[nb];
    nb ^= 1;
  }
  return cur;
}

// the stacked readout's layer-0 items fused with the jump's backward: a
// thread of (row r, unit j) sums column j of the dx product for both
// stacked rows, then dhe, dh1 and df (and, with the GRU jump, the gate
// gradients dG from dhe and the saved gates); the step's forward values
// at fs
__device__ __forceinline__ void ro0_item(const ScanCfg& c, float* sm,
                                         const float* fs, int R,
                                         const BLin& L, const IO& cu,
                                         float dt, int e) {
  const int H = c.H, O = c.O, RH = R * H;
  const int r = e / H, j = e - r * H;
  const float* in_ro = fs + c.o_in_ro;
  const float* dst = sm + c.o_dst;
  float a, b;
  dot_col2(L.d + r * L.out, L.d + (R + r) * L.out, L.W, L.out, L.in, j, a,
           b);
  float a1 = in_ro[e], a2 = in_ro[RH + e];
  float dt1 = a * (1.f - a1 * a1)
              + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
  float dt2 = b * (1.f - a2 * a2)
              + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O, O, j);
  float o = cu.obs[r];
  float d2 = sm[c.o_dh + e] + dt2;
  float d = o * d2;
  sm[c.o_dhe + e] = d;
  float d1 = (1.f - o) * d2 + dt1;
  sm[c.o_dh1 + e] = d1;
  sm[c.o_df + e] = dt * d1;
  if (c.use_rnn) {
    const float* sv = fs + c.o_gru;
    float rg = sv[e], z = sv[RH + e], n = sv[2 * RH + e];
    float da_n = d * (1.f - z) * (1.f - n * n);
    float* q = sm + c.o_dG + r * 4 * H;
    q[j] = da_n * sv[3 * RH + e] * rg * (1.f - rg);          // da_r
    q[H + j] = d * (a1 - n) * z * (1.f - z);                  // da_z
    q[2 * H + j] = da_n;                                      // dgi_n
    q[3 * H + j] = da_n * rg;                                 // dgh_n
  }
}

// the GRU jump's backward after its gate gradients (dG): their deltas into
// the workspace records at wsr (X is data: no dx) and dh1 += (dh' z +
// sum_g dgh_g W_hh[g]) (1 - h_t^2), df = dt dh1; one phase
__device__ void res_gru_bwd(const ScanCfg& c, float* sm, const float* fs,
                            int R, int nv, float dt, float* wsr) {
  const int H = c.H, RH = R * H, H3 = 3 * H;
  const float* Whh = sm + c.o_w + c.gru_whh;
  const float* ht = fs + c.o_in_ro;
  const float* sv = fs + c.o_gru;
  const float* dG = sm + c.o_dG;
  const float* dhe = sm + c.o_dhe;
  float* dh1 = sm + c.o_dh1;
  float* df = sm + c.o_df;
  const int n = RH + nv * H3;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    int q = e;
    if (q < RH) {
      const int r = q / H, i = q - r * H;
      float acc = dhe[q] * sv[RH + q];                        // dh' * z
      for (int gj = 0; gj < H3; ++gj)
        acc = fmaf(dgh_at(dG, H, r, gj), Whh[gj * H + i], acc);
      float t = ht[q];
      float d1 = dh1[q] + acc * (1.f - t * t);
      dh1[q] = d1;
      df[q] = dt * d1;
      continue;
    }
    put_gru_delta(c, dG, wsr, q - RH);
  }
  phase_end();
}

// items of the ODE net's layer-0 phase fused with the Euler step's
// backward: dh = dh1 + dx_h (1 - tanh^2 h), dlast_X likewise, dtau (the
// input_current_t feature tau + tdiff == t_prev is constant in tau)
__device__ __forceinline__ int n_ode0(const ScanCfg& c, int R) {
  return R * c.H + R * c.D + R;
}

__device__ __forceinline__ void ode0_item(const ScanCfg& c, float* sm,
                                          int R, const BLin& L,
                                          const IO& cu, int e) {
  const int D = c.D, H = c.H, iw = c.ode.w_in;
  if (e < R * H) {
    const int r = e / H, j = e - r * H;
    float th = cu.in_ode[r * iw + D + j];
    sm[c.o_dh + e] = sm[c.o_dh1 + e]
        + dot_col(L.d + r * L.out, L.W, L.out, iw, D + j) * (1.f - th * th);
    return;
  }
  e -= R * H;
  if (e < R * D) {
    const int r = e / D, q = e - r * D;
    float tl = cu.in_ode[r * iw + q];
    sm[c.o_dlx + e] = sm[c.o_dlxc + e]
        + dot_col(L.d + r * L.out, L.W, L.out, iw, q) * (1.f - tl * tl);
    return;
  }
  e -= R * D;
  const float* d = L.d + e * L.out;
  sm[c.o_dtau + e] = sm[c.o_dtauc + e]
                     + dot_col(d, L.W, L.out, iw, D + H)
                     - dot_col(d, L.W, L.out, iw, D + H + 1);
}

// K1 (WANT_HISTS) / K3 in the resident plan
template <bool WANT_HISTS, int RT>
__device__ void res_scan_fwd(const ScanCfg& c, const int* tab, float* sm,
                             const float* times, const float* dts,
                             const float* obs_g, const float* X_g,
                             const float* M_g, const int8_t* u,
                             const long long* seed, const float* n_obs,
                             const float* h0, const float* sx,
                             float* loss_part, float* hh, float* lxh,
                             float* tauh) {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, c.B - row0);
  load_weights(c, tab, sm);
  float* nobs = sm + c.o_nobs;
  float* lrow = sm + c.o_lrow;
  const IO s0 = io_set(c, sm, 0);
  for (int idx = threadIdx.x; idx < R * H; idx += NTHREADS) {
    bool ok = idx / H < nv;
    float v = ok ? h0[(size_t)row0 * H + idx] : 0.f;
    s0.h[idx] = v;
    if (WANT_HISTS && ok) hh[(size_t)row0 * H + idx] = v;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += NTHREADS) {
    bool ok = idx / D < nv;
    float v = ok ? sx[(size_t)row0 * D + idx] : 0.f;
    s0.lx[idx] = v;
    if (WANT_HISTS && ok) lxh[(size_t)row0 * D + idx] = v;
  }
  for (int r = threadIdx.x; r < R; r += NTHREADS) {
    s0.tau[r] = 0.f;
    lrow[r] = 0.f;
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
    if (WANT_HISTS && r < nv) tauh[row0 + r] = 0.f;
  }
  stage_inputs(c, s0, 0, row0, nv, R, times, dts, obs_g, X_g, M_g, nullptr,
               nullptr, nullptr);
  cp_async_wait_all();
  phase_end();
  MaskCtx mc = make_mask_ctx(c, sm, u, seed, row0, nv);
  Fill f0 = fill_of(c, sm, R, mc, 0);      // step 0's mask words
  items_fill(mc, &f0, n_build(c, R), true,
             [&](int e) { build_item(c, s0, R, e); });
  phase_end();
  for (int k = 0; k < c.K; ++k) {
    phase_clock_step(k, c.K);
    const IO cu = io_set(c, sm, k), nx = io_set(c, sm, k + 1);
    if (k + 1 < c.K)
      stage_inputs(c, nx, k + 1, row0, nv, R, times, dts, obs_g, X_g, M_g,
                   nullptr, nullptr, nullptr);
    mc.bits = mask_set(c, sm, R, k);
    Fill f = fill_of(c, sm, R, mc, k + 1);   // the next step's
    res_step_forward(c, sm, R, cu, mc, f);
    cp_async_wait_all();
    phase_end();
    res_carry<WANT_HISTS>(c, sm, R, cu, nx, k, row0, nv, hh, lxh, tauh, mc,
                          f);
    phase_end();
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += lrow[r];
    loss_part[blockIdx.x] = s;
  }
}

// K2 stage (b), the chain, in the resident plan: the steps k1 - 1 .. k0 of
// the CTA's R rows, backwards. A step's forward values come from stage
// (a)'s workspace records: get_fields copies them (fld) with cp.async into
// the step's io set beside its inputs, while the step after them in the
// walk (the one before in time) works on the other set, so a step reads
// its forward values at fs, sm + fo. The carries' gradients (dh, dlast_X,
// dtau) start at zero in the last chunk (`first`), else from dh0 and carry
// where the chunk after left them, and go back there at the end. Every
// delta a weight gradient needs goes to the step's records (put_delta);
// stage (c) sums the weight gradients.
template <int RT>
__device__ void res_chain(const ScanCfg& c, const int* tab, float* sm,
                          const float* times, const float* dts,
                          const float* obs_g, const float* X_g,
                          const float* M_g, const int8_t* u,
                          const long long* seed, const float* n_obs,
                          const float* dloss_p, float* ws,
                          const int* fld, int n_fld, float* carry,
                          float* dh0, int k0, int k1, int first) {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, O = c.O, RH = R * H;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, c.B - row0);
  load_weights(c, tab, sm);
  float* dh = sm + c.o_dh;
  float* dhe = sm + c.o_dhe;
  float* dh1 = sm + c.o_dh1;
  float* df = sm + c.o_df;
  float* dst = sm + c.o_dst;
  float* dA = sm + c.o_dA;
  float* dB = sm + c.o_dB;
  float* dlx = sm + c.o_dlx;
  float* dtau = sm + c.o_dtau;
  float* cr = carry + (size_t)row0 * (D + 1);    // the rows' [dlast_X, dtau]
  for (int i = threadIdx.x; i < RH; i += blockDim.x)
    dh[i] = first || i / H >= nv ? 0.f : dh0[(size_t)row0 * H + i];
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    dlx[i] = first || r >= nv ? 0.f : cr[r * (D + 1) + i - r * D];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dtau[r] = first || r >= nv ? 0.f : cr[r * (D + 1) + D];
    sm[c.o_nobs + r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  const float dloss = dloss_p[0];
  MaskCtx mc = make_mask_ctx(c, sm, u, seed, row0, nv);
  // step k's records: wsb + (k - k0) * B * rec
  float* wsb = ws + (size_t)row0 * c.rec;
  const size_t step_recs = (size_t)c.B * c.rec;
  auto fetch = [&](int k) {
    stage_inputs(c, io_set(c, sm, k), k, row0, nv, R, times, dts, obs_g,
                 X_g, M_g, nullptr, nullptr, nullptr);
    float* fs = sm + (k & 1) * c.io_stride;
    if (R == 1)         // the io set's forward floats: the record's image
      get_record(fs + c.o_in_ode, wsb + (k - k0) * step_recs, n_fld);
    else
      get_fields(fld, n_fld, fs, wsb + (k - k0) * step_recs, c.rec, R, nv);
  };
  fetch(k1 - 1);
  cp_async_wait_all();
  phase_end();
  for (int k = k1 - 1; k >= k0; --k) {
    phase_clock_step(k, c.K);
    const IO cu = io_set(c, sm, k);
    const int fo = (k & 1) * c.io_stride;
    const float* fs = sm + fo;
    float* in_ro = sm + fo + c.o_in_ro;
    float* wsr = wsb + (k - k0) * step_recs;
    if (k > k0) fetch(k - 1);
    mc.bits = reinterpret_cast<const uint32_t*>(fs + c.o_mw);
    res_loss_grads(c, sm, fs, R, cu, dloss);
    phase_end();
    const float dt = cu.tdt[1];
    const Net ode{&c.ode, cu.in_ode, R, R, 0, fo};
    if (!c.masked && !c.use_rnn) {
      // the stacked readout, then the ODE net and the encoder side by
      // side from their tops (the encoder's input is data: no dx)
      const Net rs{&c.ro, in_ro, 2 * R, R, c.ro.n_lin - 1, fo};
      const float* d = bwd_upper(c, sm, rs, dst, dA, dB, nv, wsr, mc);
      const BLin L0 = blin_of(c, sm, rs, 0, d, nullptr, nv, wsr);
      bwd_phase(&L0, nullptr, RH,
                [&](int e) { ro0_item(c, sm, fs, R, L0, cu, dt, e); }, mc);
      const Net enc{&c.enc, cu.tX, R, R, 0, fo};
      const float* co = df;
      const float* ce = dhe;
      float* ob[2] = {dA, dB};
      float* eb[2] = {dA + R * c.buf_w, dB + R * c.buf_w};
      int no = 0, ne = 0;
      for (int lo = c.ode.n_lin - 1, le = c.enc.n_lin - 1;
           lo >= 0 || le >= 0; --lo, --le) {
        BLin Ol = {}, El = {};
        if (lo >= 0) Ol = blin_of(c, sm, ode, lo, co, ob[no], nv, wsr);
        if (le >= 0) El = blin_of(c, sm, enc, le, ce, eb[ne], nv, wsr);
        bwd_phase(lo >= 0 ? &Ol : nullptr, le >= 0 ? &El : nullptr,
                  lo == 0 ? n_ode0(c, R) : 0,
                  [&](int e) { ode0_item(c, sm, R, Ol, cu, e); }, mc,
                  lo <= 0 && le <= 0);
        if (lo > 0) { co = ob[no]; no ^= 1; }
        if (le > 0) { ce = eb[ne]; ne ^= 1; }
      }
      continue;
    }
    if (c.use_rnn) {
      const Net rs{&c.ro, in_ro, 2 * R, R, c.ro.n_lin - 1, fo};
      const float* d = bwd_upper(c, sm, rs, dst, dA, dB, nv, wsr, mc);
      const BLin L0 = blin_of(c, sm, rs, 0, d, nullptr, nv, wsr);
      bwd_phase(&L0, nullptr, RH,
                [&](int e) { ro0_item(c, sm, fs, R, L0, cu, dt, e); }, mc);
      res_gru_bwd(c, sm, fs, R, nv, dt, wsr);
    } else {
      // masked: the post-jump readout (input tanh h2)
      const Net r2{&c.ro2, in_ro + RH, R, R, 0, fo};
      const float* d = bwd_upper(c, sm, r2, dst + R * O, dA, dB, nv, wsr, mc);
      const BLin L2 = blin_of(c, sm, r2, 0, d, nullptr, nv, wsr);
      bwd_phase(&L2, nullptr, RH, [&](int e) {
        const int r = e / H, j = e - r * H;
        float a2 = in_ro[RH + e];
        float d2 = dh[e]
            + dot_col(L2.d + r * L2.out, L2.W, L2.out, L2.in, j)
                  * (1.f - a2 * a2)
            + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O, O, j);
        float o = cu.obs[r];
        dhe[e] = o * d2;
        dh1[e] = (1.f - o) * d2;
      }, mc);
      // the encoder to its input [tanh X_imp, M]; X_imp = X*M + (1-M)*y_bj,
      // X and M are data, so dX_imp flows into dy_bj
      const Net en{&c.enc, cu.tX, R, R, 0, fo};
      d = bwd_upper(c, sm, en, dhe, dA, dB, nv, wsr, mc);
      const BLin E0 = blin_of(c, sm, en, 0, d, nullptr, nv, wsr);
      bwd_phase(&E0, nullptr, R * D, [&](int e) {
        const int r = e / D, q = e - r * D;
        float tx = cu.tX[r * 2 * D + q];
        float dxi = dot_col(E0.d + r * E0.out, E0.W, E0.out, E0.in, q)
                        * (1.f - tx * tx)
                    + residual_bwd(c.enc_case, c.enc_mult, dhe + r * H, H,
                                   q);
        dst[r * O + q] += (1.f - cu.M[e]) * dxi;
      }, mc);
      // the pre-jump readout (input tanh h1)
      const Net r1{&c.ro, in_ro, R, R, 0, fo};
      d = bwd_upper(c, sm, r1, dst, dA, dB, nv, wsr, mc);
      const BLin L1 = blin_of(c, sm, r1, 0, d, nullptr, nv, wsr);
      bwd_phase(&L1, nullptr, RH, [&](int e) {
        const int r = e / H, j = e - r * H;
        float a1 = in_ro[e];
        float d1 = dh1[e]
            + dot_col(L1.d + r * L1.out, L1.W, L1.out, L1.in, j)
                  * (1.f - a1 * a1)
            + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
        dh1[e] = d1;
        df[e] = dt * d1;
      }, mc);
    }
    // the Euler step's backward: h1 = h + dt * f(ode_in)
    const float* d = bwd_upper(c, sm, ode, df, dA, dB, nv, wsr, mc);
    const BLin O0 = blin_of(c, sm, ode, 0, d, nullptr, nv, wsr);
    bwd_phase(&O0, nullptr, n_ode0(c, R),
              [&](int e) { ode0_item(c, sm, R, O0, cu, e); }, mc, true);
  }
  for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
    dh0[(size_t)row0 * H + idx] = dh[idx];
  for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x) {
    const int r = idx / D;
    cr[r * (D + 1) + idx - r * D] = dlx[idx];
  }
  for (int r = threadIdx.x; r < nv; r += blockDim.x) cr[r * (D + 1) + D] = dtau[r];
}

// K2 stage (a), the forward re-run (resident plan): CTA x of member
// blockIdx.y re-runs step k0 + x / nb (nb: the CTAs of a step) for its R
// rows from the stored carries, with the forward's code at its layout
// (res_step_forward: the bits the chain's walk used to re-run), and writes
// the fields of the workspace records that the chain and stage (c) read
// (fld) for its valid rows
template <int RT>
__global__ void __launch_bounds__(NTHREADS, CTAS_PER_SM)
njode_remat_kernel(ScanCfg c, const int* __restrict__ tab,
                   const float* __restrict__ times,
                   const float* __restrict__ dts,
                   const float* __restrict__ obs_g,
                   const float* __restrict__ X_g,
                   const float* __restrict__ M_g, const int8_t* u,
                   const long long* seed, const float* __restrict__ hh,
                   const float* __restrict__ lxh,
                   const float* __restrict__ tauh, float* ws,
                   const int* __restrict__ fld, int n_fld, int k0, int Kc) {
  extern __shared__ float sm[];
  {
    const size_t KB = (size_t)c.K * c.B;
    obs_g = member_of(obs_g, KB);
    X_g = member_of(X_g, KB * c.D);
    M_g = member_of(M_g, KB * c.D);
    u = member_of(u, KB * c.S * c.Wmax);
    seed = member_of(seed, 1);
    hh = member_of(hh, KB * c.H);
    lxh = member_of(lxh, KB * c.D);
    tauh = member_of(tauh, KB);
    ws = member_of(ws, (size_t)Kc * c.B * c.rec);
  }
  load_tables(c, tab, sm);
  const int R = RT ? RT : c.rows;
  const int nb = (c.B + R - 1) / R;
  const int kl = blockIdx.x / nb, k = k0 + kl;
  const int row0 = (blockIdx.x - kl * nb) * R;
  const int nv = min(R, c.B - row0);
  load_weights(c, tab, sm);
  const IO s = io_set(c, sm, 0);
  stage_inputs(c, s, k, row0, nv, R, times, dts, obs_g, X_g, M_g, hh, lxh,
               tauh);
  cp_async_wait_all();
  phase_end();
  // the step's mask words into the first set, then its ODE and jump inputs
  MaskCtx mc = make_mask_ctx(c, sm, u, seed, row0, nv);
  Fill f{mask_set(c, sm, R, 0), k, 0,
         mc.mode ? R * c.S * (1 << c.lg_nw) : 0, R};
  items_fill(mc, &f, n_build(c, R), true,
             [&](int e) { build_item(c, s, R, e); });
  phase_end();
  Fill none{nullptr, k, 0, 0, R};
  res_step_forward(c, sm, R, s, mc, none);
  phase_end();
  put_fields(fld, n_fld, sm, ws + ((size_t)kl * c.B + row0) * c.rec, c.rec,
             nv);
}

// K2 stage (c), the weight gradients: CTA x of member blockIdx.y owns
// output tile x % n_tiles (tiles: 8 ints, the weight leaf's offset, its
// columns `in` and rows `out`, the tile's first row j0 and column i0, its
// first job and job count, and its bias leaf's offset or -1: the bias is
// the weight's column `in`, its x a column of ones) and stretch s = x /
// n_tiles of the chunk's steps (Ks steps, all B rows each: the chunk's
// stretch s is stretch s0 + s of the call). dtx_tile (dtx.cuh) sums
// d[j] x[i] over every (step, row) record of its stretch for each of the
// leaf's jobs (jobs: 2 ints, the record offsets of x and of d), in job
// order, then record order, into the call's partial row of that stretch.
// The order depends on neither the rows per CTA, nor the plan, nor the
// chunk length, nor the member axis.
__global__ void __launch_bounds__(DTX_NT)
njode_wgrad_kernel(const float* __restrict__ ws, int rec, int B,
                   int steps, int Ks, int s0, const int* __restrict__ tiles,
                   const int* __restrict__ jobs, int n_tiles,
                   float* partials, int n_params, int n_parts,
                   size_t ws_member) {
  ws += blockIdx.y * ws_member;
  partials += (size_t)blockIdx.y * n_parts * n_params;
  const int s = blockIdx.x / n_tiles;
  const int* tp = tiles + (blockIdx.x - s * n_tiles) * 8;
  const DtxTile t{__ldg(tp), __ldg(tp + 1), __ldg(tp + 2), __ldg(tp + 4),
                  __ldg(tp + 3), __ldg(tp + 5), __ldg(tp + 6),
                  __ldg(tp + 7)};
  const auto job_at = [&](int q) {
    return DtxJob{ws + __ldg(jobs + 2 * q), rec,
                  ws + __ldg(jobs + 2 * q + 1), rec};
  };
  dtx_tile(t, job_at, s * Ks * B, min(steps, (s + 1) * Ks) * B,
           partials + (size_t)(s0 + s) * n_params, true, false);
}

// K1 (WANT_HISTS) and K3: the resident plan's body above, or (GW) the
// global plan's
template <bool WANT_HISTS, bool GW, int RT>
__global__ void __launch_bounds__(NTHREADS, GW ? 1 : CTAS_PER_SM)
njode_scan_fwd_kernel(ScanCfg c, const int* __restrict__ tab,
                      const float* __restrict__ wg,
                      const int* __restrict__ prog,
                      const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g,
                      const float* __restrict__ M_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ h0,
                      const float* __restrict__ sx, float* loss_part,
                      float* hh, float* lxh, float* tauh) {
  extern __shared__ float sm[];
  {
    const size_t KB = (size_t)c.K * c.B;
    obs_g = member_of(obs_g, KB);
    X_g = member_of(X_g, KB * c.D);
    M_g = member_of(M_g, KB * c.D);
    u = member_of(u, KB * c.S * c.Wmax);
    seed = member_of(seed, 1);
    n_obs = member_of(n_obs, c.B);
    h0 = member_of(h0, (size_t)c.B * c.H);
    sx = member_of(sx, (size_t)c.B * c.D);
    loss_part = member_of(loss_part, gridDim.x);
    hh = member_of(hh, KB * c.H);
    lxh = member_of(lxh, KB * c.D);
    tauh = member_of(tauh, KB);
    wg = member_of(wg, c.wg_stride);
  }
  load_tables(c, tab, sm);
  if constexpr (!GW) {
    res_scan_fwd<WANT_HISTS, RT>(c, tab, sm, times, dts, obs_g, X_g, M_g, u,
                                 seed, n_obs, h0, sx, loss_part, hh, lxh,
                                 tauh);
  } else {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs;
  float* nobs = sm + c.o_nobs; float* lrow = sm + c.o_lrow;
  float* Mm = sm + c.o_M;
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    int r = idx / H;
    h[idx] = r < nv ? h0[(size_t)row0 * H + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    int r = idx / D;
    lx[idx] = r < nv ? sx[(size_t)row0 * D + idx] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    tau[r] = 0.f;
    lrow[r] = 0.f;
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  MaskCtx mc = make_mask_ctx(c, sm, u, seed, row0, nv);
  // the global plan's weight ring: the forward's tiles, step after step
  Ring rg{prog, c.n_tiles_fwd, 0, c.stage, sm + c.o_ring, wg};
  ring_issue(rg, 0);
  Fill f0 = fill_of(c, sm, R, mc, 0);        // step 0's mask words
  items_fill(mc, &f0, 0, true, [](int) {});
  __syncthreads();
  for (int k = 0; k < c.K; ++k) {
    const float t = times[k], dt = dts[k];
    if (WANT_HISTS) {
      for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
        hh[((size_t)k * B + row0) * H + idx] = h[idx];
      for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x)
        lxh[((size_t)k * B + row0) * D + idx] = lx[idx];
      for (int r = threadIdx.x; r < nv; r += blockDim.x)
        tauh[(size_t)k * B + row0 + r] = tau[r];
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      obs[r] = r < nv ? obs_g[(size_t)k * B + row0 + r] : 0.f;
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D;
      size_t gi = ((size_t)k * B + row0) * D + idx;
      X[idx] = r < nv ? X_g[gi] : 0.f;
      if (c.masked) Mm[idx] = r < nv ? M_g[gi] : 0.f;
    }
    step_forward<RT>(c, sm, rg, t, dt, mc);
    // per-row loss term, then the carry updates (masked: last_X takes the
    // post-jump prediction, O == D)
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float s1, s2, g;
      row_errors(c, sm, R, r, s1, s2, g);
      lrow[r] += obs[r] * g * g / fmaxf(nobs[r], 1.f);
      if (obs[r] > 0.f) tau[r] = t;
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D;
      if (obs[r] > 0.f)
        lx[idx] = c.masked ? y_at(c, sm, R, R + r, idx - r * D) : X[idx];
    }
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = sm[c.o_h2 + idx];
    // the next step's mask words (step k read its last before
    // step_forward's last barrier)
    Fill f = fill_of(c, sm, R, mc, k + 1);
    items_fill(mc, &f, 0, true, [](int) {});
    __syncthreads();
  }
  cp_async_wait_all();           // the next step's first tile, unused
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += lrow[r];
    loss_part[blockIdx.x] = s;
  }
  }
}

// K2 stage (b), the chain of steps [k0, k1): the resident plan's body
// above, or (GW) the global plan's, which re-runs each step inline
// (step_forward, its weights through the ring), writes the fields that
// stage (c) reads (fld: the Linears' inputs) and then walks its backward
// as the resident chain does, the carries' gradients passing from chunk
// to chunk the same way
template <bool GW, int RT>
__global__ void __launch_bounds__(NTHREADS, GW ? 1 : CTAS_PER_SM)
njode_scan_bwd_kernel(ScanCfg c, const int* __restrict__ tab,
                      const float* __restrict__ wg,
                      const int* __restrict__ prog,
                      const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g,
                      const float* __restrict__ M_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ hh,
                      const float* __restrict__ lxh,
                      const float* __restrict__ tauh, const float* dloss_p,
                      float* ws, const int* __restrict__ fld, int n_fld,
                      float* carry, float* dh0, int k0, int k1, int Kc,
                      int first) {
  extern __shared__ float sm[];
  {
    const size_t KB = (size_t)c.K * c.B;
    obs_g = member_of(obs_g, KB);
    X_g = member_of(X_g, KB * c.D);
    M_g = member_of(M_g, KB * c.D);
    u = member_of(u, KB * c.S * c.Wmax);
    seed = member_of(seed, 1);
    n_obs = member_of(n_obs, c.B);
    hh = member_of(hh, KB * c.H);
    lxh = member_of(lxh, KB * c.D);
    tauh = member_of(tauh, KB);
    dloss_p = member_of(dloss_p, 1);
    ws = member_of(ws, (size_t)Kc * c.B * c.rec);
    carry = member_of(carry, (size_t)c.B * (c.D + 1));
    dh0 = member_of(dh0, (size_t)c.B * c.H);
    wg = member_of(wg, c.wg_stride);
  }
  load_tables(c, tab, sm);
  if constexpr (!GW) {
    res_chain<RT>(c, tab, sm, times, dts, obs_g, X_g, M_g, u, seed, n_obs,
                  dloss_p, ws, fld, n_fld, carry, dh0, k0, k1, first);
  } else {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, O = c.O, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  const int iw = c.ode.w_in;
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs; float* nobs = sm + c.o_nobs;
  float* dh = sm + c.o_dh; float* dlx = sm + c.o_dlx; float* dtau = sm + c.o_dtau;
  float* rs = sm + c.o_rs; float* dst = sm + c.o_dst; float* dh1 = sm + c.o_dh1;
  float* dhe = sm + c.o_dhe; float* df = sm + c.o_df;
  float* dlxc = sm + c.o_dlxc; float* dtauc = sm + c.o_dtauc;
  float* Mm = sm + c.o_M;
  float* cr = carry + (size_t)row0 * (D + 1);    // the rows' [dlast_X, dtau]
  for (int i = threadIdx.x; i < R * H; i += blockDim.x)
    dh[i] = first || i / H >= nv ? 0.f : dh0[(size_t)row0 * H + i];
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) {
    const int r = i / D;
    dlx[i] = first || r >= nv ? 0.f : cr[r * (D + 1) + i - r * D];
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dtau[r] = first || r >= nv ? 0.f : cr[r * (D + 1) + D];
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  const float dloss = dloss_p[0];
  MaskCtx mc = make_mask_ctx(c, sm, u, seed, row0, nv);
  // the global plan's weight ring: the forward's tiles, then the
  // backward's, step after step
  Ring rg{prog, c.n_tiles_fwd + c.n_tiles_bwd, 0, c.stage, sm + c.o_ring, wg};
  ring_issue(rg, 0);
  Fill f0 = fill_of(c, sm, R, mc, k1 - 1);   // the walk's first step's words
  items_fill(mc, &f0, 0, true, [](int) {});
  __syncthreads();
  for (int k = k1 - 1; k >= k0; --k) {
    float* wsr = ws + ((size_t)(k - k0) * B + row0) * c.rec;
    const float t = times[k], dt = dts[k];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = idx / H < nv ? hh[((size_t)k * B + row0) * H + idx] : 0.f;
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      bool ok = idx / D < nv;
      size_t gi = ((size_t)k * B + row0) * D + idx;
      lx[idx] = ok ? lxh[gi] : 0.f;
      X[idx] = ok ? X_g[gi] : 0.f;
      if (c.masked) Mm[idx] = ok ? M_g[gi] : 0.f;
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      bool ok = r < nv;
      tau[r] = ok ? tauh[(size_t)k * B + row0 + r] : 0.f;
      obs[r] = ok ? obs_g[(size_t)k * B + row0 + r] : 0.f;
    }
    step_forward<RT>(c, sm, rg, t, dt, mc);
    put_fields(fld, n_fld, sm, wsr, c.rec, nv);
    // loss gradients per row: rs = (de1, de2)
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float s1, s2, gg;
      row_errors(c, sm, R, r, s1, s2, gg);
      float fac = c.easy ? 1.f : 2.f;
      float dinner = dloss * obs[r] / fmaxf(nobs[r], 1.f) / (float)B;
      float dg = 2.f * gg * dinner;
      rs[2 * r] = (fac * c.weight * dg) * (0.5f / s1);
      rs[2 * r + 1] = (fac * (1.f - c.weight) * dg) * (0.5f / s2);
      float o = obs[r];
      dtauc[r] = (1.f - o) * dtau[r];
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
      dlxc[idx] = (1.f - obs[idx / D]) * dlx[idx];
    __syncthreads();
    // d_stack = [dy_bj ; dy]; masked: M weighs each coordinate, and
    // last_X2 = where(obs, y, last_X) adds obs * dlast_X to dy
    for (int idx = threadIdx.x; idx < R * O; idx += blockDim.x) {
      int r = idx / O, o = idx - r * O;
      float yb = y_at(c, sm, R, r, o), y = y_at(c, sm, R, R + r, o);
      float dy, dyb;
      if (c.D == c.O) {
        float x = X[r * D + o];
        float m = c.masked ? Mm[r * D + o] : 1.f;
        float de1 = rs[2 * r] * m, de2 = rs[2 * r + 1] * m;
        dy = de1 * 2.f * (y - x);
        dyb = de2 * 2.f * (yb - (c.easy ? x : y));
        if (!c.easy) dy += de2 * 2.f * (y - yb);
        if (c.masked) dy += obs[r] * dlx[r * D + o];
      } else {                     // summed over the broadcast X
        const float2 d = bcast_grads(
            bcast_row(c, sm + c.o_h1, sm + c.o_h2, sm + c.o_ro, X, R, r), o,
            rs[2 * r], rs[2 * r + 1]);
        dy = d.x;
        dyb = d.y;
      }
      dst[idx] = dyb;
      dst[R * O + idx] = dy;
    }
    __syncthreads();
    const float* in_ro = sm + c.o_in_ro;
    if (!c.masked || c.use_rnn) {
      // stacked readout backward
      mc.half = R; mc.jump = c.ro.n_lin - 1;
      const float* d_rin = mlp_bwd(c, c.ro, sm, rg, wsr, 2 * R, dst, true,
                                   mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a1 = in_ro[idx], a2 = in_ro[R * H + idx];
        float dt1 = d_rin[idx] * (1.f - a1 * a1)
                    + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
        float dt2 = d_rin[R * H + idx] * (1.f - a2 * a2)
                    + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O,
                                   O, j);
        float o = obs[r];
        float d2 = dh[idx] + dt2;
        dhe[idx] = o * d2;
        float d1 = (1.f - o) * d2 + dt1;
        dh1[idx] = d1;
        df[idx] = dt * d1;
      }
      __syncthreads();
      mc.half = 2 * R; mc.jump = 0;
      // the jump's backward: X is data, only the weights get gradients
      if (c.use_rnn) gru_bwd(c, sm, rg, wsr, R, nv, dt);
      else mlp_bwd(c, c.enc, sm, rg, wsr, R, dhe, false, mc);
    } else {
      mc.half = 2 * R; mc.jump = 0;
      // post-jump readout backward (input tanh h2)
      const float* d_r2 = mlp_bwd(c, c.ro2, sm, rg, wsr, R, dst + R * O,
                                  true, mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a2 = in_ro[R * H + idx];
        float d2 = dh[idx] + d_r2[idx] * (1.f - a2 * a2)
                   + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O, O,
                                  j);
        float o = obs[r];
        dhe[idx] = o * d2;
        dh1[idx] = (1.f - o) * d2;
      }
      __syncthreads();
      // encoder backward to its input [tanh X_imp, M]; X_imp = X*M +
      // (1-M)*y_bj, X and M are data, so dX_imp flows into dy_bj
      const float* d_ein = mlp_bwd(c, c.enc, sm, rg, wsr, R, dhe, true, mc);
      const float* tX = sm + c.o_tX;
      for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
        int r = idx / D, q = idx - r * D;
        float tx = tX[r * 2 * D + q];
        float dxi = d_ein[r * 2 * D + q] * (1.f - tx * tx)
                    + residual_bwd(c.enc_case, c.enc_mult, dhe + r * H, H, q);
        dst[r * O + q] += (1.f - Mm[idx]) * dxi;
      }
      __syncthreads();
      // pre-jump readout backward (input tanh h1)
      const float* d_r1 = mlp_bwd(c, c.ro, sm, rg, wsr, R, dst, true, mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a1 = in_ro[idx];
        float d1 = dh1[idx] + d_r1[idx] * (1.f - a1 * a1)
                   + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
        dh1[idx] = d1;
        df[idx] = dt * d1;
      }
      __syncthreads();
    }
    // Euler step backward: h1 = h + dt * f(ode_in)
    const float* dino = mlp_bwd(c, c.ode, sm, rg, wsr, R, df, true, mc);
    const float* in_ode = sm + c.o_in_ode;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float th = in_ode[r * iw + D + j];
      dh[idx] = dh1[idx] + dino[r * iw + D + j] * (1.f - th * th);
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D, q = idx - r * D;
      float tl = in_ode[r * iw + q];
      dlx[idx] = dlxc[idx] + dino[r * iw + q] * (1.f - tl * tl);
    }
    // the input_current_t feature tau + tdiff == t_prev is constant in tau
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      dtau[r] = dtauc[r] + dino[r * iw + D + H] - dino[r * iw + D + H + 1];
    // step k - 1's mask words (step k read its last before mlp_bwd's last
    // barrier)
    Fill f = fill_of(c, sm, R, mc, k > k0 ? k - 1 : -1);
    items_fill(mc, &f, 0, true, [](int) {});
    __syncthreads();
  }
  cp_async_wait_all();           // the next step's first tile, unused
  for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
    dh0[(size_t)row0 * H + idx] = dh[idx];
  for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x) {
    const int r = idx / D;
    cr[r * (D + 1) + idx - r * D] = dlx[idx];
  }
  for (int r = threadIdx.x; r < nv; r += blockDim.x)
    cr[r * (D + 1) + D] = dtau[r];
  }
}

// out[p] = scale * sum_c partials[c, p], summed in a fixed order; member
// blockIdx.y of a member-axis launch: partials [E, n_parts, n], out [E, n]
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int n_parts, int n, float scale,
                                       float* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  partials += (size_t)blockIdx.y * n_parts * n;
  out += (size_t)blockIdx.y * n;
  float s = 0.f;
  for (int q = 0; q < n_parts; ++q) s += partials[(size_t)q * n + p];
  out[p] = s * scale;
}

// The K4 masks of K steps written out ([K, S, B, W] int8): the draw the
// scan kernels make in 'prng' mode (one Philox a quad), for tests and
// timing.
__global__ void __launch_bounds__(256)
philox_masks_kernel(const long long* seed, int K, int S, int B, int W,
                    unsigned thresh, int8_t* out) {
  philox_mask_rows(seed, K, S, B, W, thresh, out);
}

// ------------------------------------------------------------ C interface

extern "C" const char* njode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// the rows per CTA and the plan the config names, a layer table, and the
// packed weights and the ring's tile program exactly when the plan is
// global
static bool cfg_ok(const ScanCfg* c, const int* tab, const float* wg,
                   const int* prog) {
  return c->rows >= 1 && c->rows <= MAX_ROWS
         && (c->plan == 0 || c->plan == 1) && tab != nullptr
         && (c->plan == 1) == (wg != nullptr)
         && (c->plan == 1) == (prog != nullptr);
}

// reduce_partials on the stream, for each of E members
static cudaError_t launch_reduce(const float* P, int n_parts, int n,
                                 float scale, float* out, cudaStream_t st,
                                 int E = 1) {
  int threads = 256;
  dim3 grid((n + threads - 1) / threads, E);
  reduce_partials_kernel<<<grid, threads, 0, st>>>(P, n_parts, n, scale, out);
  return cudaGetLastError();
}

template <bool H, bool GW, int RT>
static cudaError_t launch_fwd(const ScanCfg* c, const int* tab,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M, const int8_t* u,
                              const long long* seed, const float* n_obs,
                              const float* h0, const float* sx,
                              float* loss_part, float* hh, float* lxh,
                              float* tauh, cudaStream_t st, int* occ,
                              int E) {
  dim3 grid((c->B + c->rows - 1) / c->rows, E);
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  auto kern = njode_scan_fwd_kernel<H, GW, RT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, NTHREADS,
                                                         smem);
  kern<<<grid, NTHREADS, smem, st>>>(*c, tab, wg, prog, times, dts, obs, X,
                                     M, u, seed, n_obs, h0, sx, loss_part,
                                     hh, lxh, tauh);
  return cudaGetLastError();
}

// RT, the rows per CTA as a compile-time constant, so the row loops unroll
// (read at run time, R slowed the resident K2 by 12 %): MAX_ROWS, and in
// the resident plan 1 (the rows rule's pick at the training batches), else
// 0 (read from c.rows)
template <bool H, bool GW>
static decltype(&launch_fwd<H, GW, 0>) fwd_for_rows(const ScanCfg* c) {
  if (c->rows == MAX_ROWS) return launch_fwd<H, GW, MAX_ROWS>;
  if constexpr (!GW)
    if (c->rows == 1) return launch_fwd<H, GW, 1>;
  return launch_fwd<H, GW, 0>;
}

// K1 (want_hists) or K3 for E members (gridDim.y = E), then the reduction
// of the per-CTA losses into loss[e] (scaled by loss_scale), both on the
// stream. tab: the layer table in device memory (LayerRec); wg: the
// weights packed at pack_off (global plan), prog: the ring's tile program
// (global plan), else null.
static int scan_fwd(const ScanCfg* c, int E, const int* tab, const float* wg,
                    const int* prog, const float* times, const float* dts,
                    const float* obs, const float* X, const float* M,
                    const int8_t* u, const long long* seed,
                    const float* n_obs, const float* h0, const float* sx,
                    float* loss_part, float* loss, float* hh, float* lxh,
                    float* tauh, int want_hists, float loss_scale,
                    void* stream) {
  if (!cfg_ok(c, tab, wg, prog) || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto f = want_hists ? (c->plan ? fwd_for_rows<true, true>(c)
                                 : fwd_for_rows<true, false>(c))
                      : (c->plan ? fwd_for_rows<false, true>(c)
                                 : fwd_for_rows<false, false>(c));
  cudaError_t e = f(c, tab, wg, prog, times, dts, obs, X, M, u, seed, n_obs,
                    h0, sx, loss_part, hh, lxh, tauh, st, nullptr, E);
  if (e != cudaSuccess) return (int)e;
  int n_cta = (c->B + c->rows - 1) / c->rows;
  return (int)launch_reduce(loss_part, n_cta, 1, loss_scale, loss, st, E);
}

// K1 or K3 of one model: loss_part [n_cta], loss [1]
extern "C" int njode_scan_fwd(const ScanCfg* c, const int* tab,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* h0,
                              const float* sx, float* loss_part, float* loss,
                              float* hh, float* lxh, float* tauh,
                              int want_hists, float loss_scale,
                              void* stream) {
  return scan_fwd(c, 1, tab, wg, prog, times, dts, obs, X, M, u, seed,
                  n_obs, h0, sx, loss_part, loss, hh, lxh, tauh, want_hists,
                  loss_scale, stream);
}

// K1 or K3 of E members of one config in one launch: every leaf [E, ...]
// (the table's addresses those of the stacked leaves), wg [E, wg_stride],
// obs/X/M/u/seed/n_obs/h0/sx and the histories with a leading member
// axis, times/dts shared; loss_part [E, n_cta], loss [E]
extern "C" int njode_scan_fwd_members(const ScanCfg* c, int n_members,
                                      const int* tab, const float* wg,
                                      const int* prog, const float* times,
                                      const float* dts, const float* obs,
                                      const float* X, const float* M,
                                      const int8_t* u,
                                      const long long* seed,
                                      const float* n_obs, const float* h0,
                                      const float* sx, float* loss_part,
                                      float* loss, float* hh, float* lxh,
                                      float* tauh, int want_hists,
                                      float loss_scale, void* stream) {
  return scan_fwd(c, n_members, tab, wg, prog, times, dts, obs, X, M, u,
                  seed, n_obs, h0, sx, loss_part, loss, hh, lxh, tauh,
                  want_hists, loss_scale, stream);
}

// K2's staged plan beyond its config (ops/fused_scan.py::_K2Work): stage
// (a)'s config (the forward layout at its own rows; the resident plan),
// the workspace [E][Kc * B][rec] and the carries [E][B][D + 1] between
// chunks, the field programs of stage (a) and of the chain (4 ints a
// field, put_fields), stage (c)'s tiles and jobs, chunk and stretch
// lengths (Kc a multiple of Ks), and the threads of a chain CTA (256, or
// 128 in the resident plan at one row a CTA, where the launch's CTAs
// overflow a wave of two an SM: the kernel's registers hold four CTAs of
// 128 threads an SM, and its phases hold few items at one row)
struct K2Work {
  ScanCfg a;
  float* ws;
  float* carry;
  const int* fa;
  const int* fb;
  const int* tiles;
  const int* jobs;
  int n_fa, n_fb, n_tiles, Kc, Ks, threads;
};

struct BwdArgs {                 // the per-call pointers of K2's kernels
  const int* tab;
  const float* wg;
  const int* prog;
  const float *times, *dts, *obs, *X, *M;
  const int8_t* u;
  const long long* seed;
  const float *n_obs, *hh, *lxh, *tauh, *dloss;
  float* dh0;
};

// the chain of steps [k0, k1) for E members; occ: the occupancy query only
template <bool GW, int RT>
static cudaError_t launch_chain(const ScanCfg* c, const K2Work* w,
                                const BwdArgs& g, int k0, int k1, int first,
                                cudaStream_t st, int* occ, int E) {
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  auto kern = njode_scan_bwd_kernel<GW, RT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = w ? w->threads : NTHREADS;
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, threads,
                                                         smem);
  dim3 grid((c->B + c->rows - 1) / c->rows, E);
  kern<<<grid, threads, smem, st>>>(
      *c, g.tab, g.wg, g.prog, g.times, g.dts, g.obs, g.X, g.M, g.u, g.seed,
      g.n_obs, g.hh, g.lxh, g.tauh, g.dloss, w->ws, w->fb, w->n_fb,
      w->carry, g.dh0, k0, k1, w->Kc, first);
  return cudaGetLastError();
}

template <bool GW>
static decltype(&launch_chain<GW, 0>) chain_for_rows(const ScanCfg* c) {
  if (c->rows == MAX_ROWS) return launch_chain<GW, MAX_ROWS>;
  if constexpr (!GW)
    if (c->rows == 1) return launch_chain<GW, 1>;
  return launch_chain<GW, 0>;
}

// stage (a) of steps [k0, k1) for E members
template <int RT>
static cudaError_t launch_remat(const K2Work* w, const BwdArgs& g, int k0,
                                int k1, cudaStream_t st, int E) {
  const ScanCfg* a = &w->a;
  size_t smem = (size_t)a->smem_floats * sizeof(float);
  auto kern = njode_remat_kernel<RT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a->B + a->rows - 1) / a->rows * (k1 - k0), E);
  kern<<<grid, NTHREADS, smem, st>>>(
      *a, g.tab, g.times, g.dts, g.obs, g.X, g.M, g.u, g.seed, g.hh, g.lxh,
      g.tauh, w->ws, w->fa, w->n_fa, k0, w->Kc);
  return cudaGetLastError();
}

// K2 for E members (gridDim.y = E): for each chunk of Kc steps, last
// first, stage (a) (resident plan), the chain and stage (c), then the
// reduction of each member's stretch partials ([E, ceil(K / Ks),
// n_params]) into grads [E, n_params], all on the stream
static int scan_bwd(const ScanCfg* c, int E, const K2Work* w,
                    const BwdArgs& g, float* partials, float* grads,
                    void* stream) {
  if (!cfg_ok(c, g.tab, g.wg, g.prog) || E < 1 || E > 65535 || !w
      || w->Kc < 1 || w->Ks < 1 || w->Kc % w->Ks || !w->ws || !w->carry
      || (w->threads != NTHREADS
          && (w->threads != 128 || c->plan != 0 || c->rows != 1))
      || (c->plan == 0 && (w->a.rows < 1 || w->a.rows > MAX_ROWS
                           || w->a.plan != 0 || w->a.rec != c->rec)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int K = c->K, B = c->B, Kc = w->Kc, Ks = w->Ks;
  const int n_parts = (K + Ks - 1) / Ks;
  auto chain = c->plan ? chain_for_rows<true>(c) : chain_for_rows<false>(c);
  auto remat = w->a.rows == MAX_ROWS ? launch_remat<MAX_ROWS>
                                     : launch_remat<0>;
  const size_t ws_member = (size_t)Kc * B * c->rec;
  for (int ci = (K + Kc - 1) / Kc - 1; ci >= 0; --ci) {
    const int k0 = ci * Kc, k1 = min(K, k0 + Kc);
    cudaError_t e = cudaSuccess;
    if (c->plan == 0) e = remat(w, g, k0, k1, st, E);
    if (e == cudaSuccess)
      e = chain(c, w, g, k0, k1, k1 == K, st, nullptr, E);
    if (e != cudaSuccess) return (int)e;
    const int n_str = (k1 - k0 + Ks - 1) / Ks;
    njode_wgrad_kernel<<<dim3(w->n_tiles * n_str, E), DTX_NT, 0, st>>>(
        w->ws, c->rec, B, k1 - k0, Ks, k0 / Ks, w->tiles, w->jobs,
        w->n_tiles, partials, c->n_params, n_parts, ws_member);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_reduce(partials, n_parts, c->n_params, 1.f, grads, st,
                            E);
}

// K2 of one model: work (K2Work), partials [ceil(K / Ks), n_params], grads
// [n_params]
extern "C" int njode_scan_bwd(const ScanCfg* c, const K2Work* work,
                              const int* tab, const float* wg,
                              const int* prog, const float* times,
                              const float* dts, const float* obs,
                              const float* X, const float* M,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* hh,
                              const float* lxh, const float* tauh,
                              const float* dloss, float* partials,
                              float* grads, float* dh0, void* stream) {
  const BwdArgs g{tab, wg, prog, times, dts, obs, X, M, u, seed, n_obs, hh,
                  lxh, tauh, dloss, dh0};
  return scan_bwd(c, 1, work, g, partials, grads, stream);
}

// K2 of E members of one config in one launch a stage and chunk (the
// member layout of njode_scan_fwd_members; dloss [E], dh0 [E, B, H], the
// workspace, carries and partials with a leading member axis)
extern "C" int njode_scan_bwd_members(const ScanCfg* c, int n_members,
                                      const K2Work* work, const int* tab,
                                      const float* wg, const int* prog,
                                      const float* times, const float* dts,
                                      const float* obs, const float* X,
                                      const float* M, const int8_t* u,
                                      const long long* seed,
                                      const float* n_obs, const float* hh,
                                      const float* lxh, const float* tauh,
                                      const float* dloss, float* partials,
                                      float* grads, float* dh0,
                                      void* stream) {
  const BwdArgs g{tab, wg, prog, times, dts, obs, X, M, u, seed, n_obs, hh,
                  lxh, tauh, dloss, dh0};
  return scan_bwd(c, n_members, work, g, partials, grads, stream);
}

// CTAs of the kernel a launch of c takes (kind 0: K1, 1: K3, 2: K2's
// chain) that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks
extern "C" int njode_scan_occupancy(const ScanCfg* c, int kind,
                                    int* blocks) {
  if (kind == 2)
    return (int)(c->plan ? chain_for_rows<true>(c)
                         : chain_for_rows<false>(c))(
        c, nullptr, BwdArgs{}, 0, 0, 0, 0, blocks, 1);
  auto f = kind == 0 ? (c->plan ? fwd_for_rows<true, true>(c)
                                : fwd_for_rows<true, false>(c))
                     : (c->plan ? fwd_for_rows<false, true>(c)
                                : fwd_for_rows<false, false>(c));
  return (int)f(c, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                nullptr, nullptr, nullptr, nullptr, 0, blocks, 1);
}

// the phase clock of the last launch (built with -DNJODE_PHASE_CLOCK, else
// *n = 0): the SM clock at the start of the middle step of CTA 0 and after
// each of its phases, n values into out[256]
extern "C" int njode_phase_clock(long long* out, int* n) {
#ifdef NJODE_PHASE_CLOCK
  cudaError_t e =
      cudaMemcpyFromSymbol(out, g_phase_clk, 256 * sizeof(long long));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(n, g_phase_n, sizeof(int));
#else
  *n = 0;
  return 0;
#endif
}

extern "C" int njode_philox_masks(const long long* seed, int K, int S, int B,
                                  int W, unsigned thresh, int8_t* out,
                                  void* stream) {
  return (int)launch_mask_rows(philox_masks_kernel, seed, K, S, B, W, thresh,
                               out, (cudaStream_t)stream);
}

// out = scale * the sum of partials' rows (row q at partials + q * n)
extern "C" int njode_reduce_partials(const float* partials, int n_parts,
                                     int n, float scale, float* out,
                                     void* stream) {
  return (int)launch_reduce(partials, n_parts, n, scale, out,
                            (cudaStream_t)stream);
}

// the same for E members in one launch: partials [E, n_parts, n], out [E, n]
extern "C" int njode_reduce_partials_members(const float* partials,
                                             int n_members, int n_parts,
                                             int n, float scale, float* out,
                                             void* stream) {
  if (n_members < 1 || n_members > 65535) return (int)cudaErrorInvalidValue;
  return (int)launch_reduce(partials, n_parts, n, scale, out,
                            (cudaStream_t)stream, n_members);
}
