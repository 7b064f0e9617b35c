// K11: one Newton pass's MNA system (A, b) written once from a stamp plan.
//
// Replaces the JAX package's scatter stamps (spicey_tpu/ops/stamps.py),
// whose port (ops/stamps.py) is this kernel's plain version: there a pass
// is one scatter-add per stamp into a zero-filled padded system. Here the
// plan (ops/stamp_real.py:build_plan) lists, for every entry of A (row * N
// + col) and of b (N * N + row), its contributions in the order the
// scatters add them: a value slot and element, or the constant 1, and a
// sign. Each entry is formed as that ordered sum and stored once, 0 where
// nothing lands, so A (nb, N, N) and b (nb, N) come out contiguous in the
// layout K2 reads.
//
// Bound: bytes (each value read once, A and b written once; one add a
// contribution). A value is read in place through its pointer, its lane
// stride (0 for a value every lane shares) and its element stride; the
// slots' pointers and strides sit in shared memory. Two forms
// (ops/stamp_real.py:form_for):
//
//   tile  (where 32 lanes' systems fit a 46 KB tile, so that the block
//         stays within the 48 KB any launch may take: N <= 13 in f64, 18
//         in f32): a block takes 32 lanes, one per thread of each warp, and
//         its 8 warps split the N * N + N entries between them. For one
//         entry the plan is the same for every thread of a warp (one
//         broadcast load) and the values of 32 neighbouring lanes lie side
//         by side (coalesced loads). Each lane's entries go to a shared
//         tile whose row pitch is odd, so a warp's stores hit distinct
//         banks; then the block stores its 32 systems as one contiguous
//         run of A and one of b.
//   entry (wider systems, whose tile would not fit): one thread an entry;
//         a block takes `lanes` whole systems, so its stores are one
//         contiguous run, and gathers the plan and the values.
//
// The entry form alone, at the boost's 1M x N = 6 in f64, reached 32% of
// the bytes bound (0.374 ms against 0.119 ms): a warp's loads there fall
// on ~14 tensors at once.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_SLOTS = 64;        // ops/stamp_real.py:MAX_SLOTS
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_LANES = 32;
constexpr int TILE_BYTES_MAX = 46 * 1024;  // ops/stamp_real.py:TILE_BYTES_MAX
constexpr int FORM_TILE = 0;         // ops/stamp_real.py:FORMS
constexpr int FORM_ENTRY = 1;
constexpr int FLAG_ACCUMULATE = 1;   // add to A and b (a later page)
constexpr int FLAG_NO_CONST = 2;     // drop the constant contributions (JVP)

struct Slots {
    const void* ptr[MAX_SLOTS];
    long long lane_stride[MAX_SLOTS];
    long long elem_stride[MAX_SLOTS];
    int count;
};

template <typename T>
struct SlotTable {
    const T* ptr[MAX_SLOTS];
    long long ls[MAX_SLOTS];
    long long es[MAX_SLOTS];

    __device__ void load(const Slots& slots)
    {
        for (int s = threadIdx.x; s < slots.count; s += blockDim.x) {
            ptr[s] = static_cast<const T*>(slots.ptr[s]);
            ls[s] = slots.lane_stride[s];
            es[s] = slots.elem_stride[s];
        }
    }
};

// Entry t's contributions for one lane, added to acc in the plan's order.
// ent[k] = (code, element): code >> 1 is the slot + 1 (0: the constant
// 1), code & 1 the sign (1: subtract). A null slot pointer (a value with no
// tangent) contributes nothing.
template <typename T>
__device__ __forceinline__ T entry_sum(T acc, const SlotTable<T>& tab,
                                       const int* __restrict__ ptr,
                                       const int2* __restrict__ ent, int t,
                                       long long lane, bool no_const)
{
    const int end = __ldg(ptr + t + 1);
    for (int k = __ldg(ptr + t); k < end; ++k) {
        const int2 e = __ldg(ent + k);
        const int s = (e.x >> 1) - 1;
        T v;
        if (s < 0) {
            if (no_const) continue;
            v = T(1);
        } else {
            const T* p = tab.ptr[s];
            if (p == nullptr) continue;
            v = __ldg(p + lane * tab.ls[s] + (long long)e.y * tab.es[s]);
        }
        acc += (e.x & 1) ? -v : v;
    }
    return acc;
}

// The tile form: 32 lanes a block, warp w forms entries w, w + 8, ... of
// every lane into the tile (TILE_LANES rows of pitch (N * N + N) | 1, in
// dynamic shared memory), then the block stores the tile.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stamp_real_tile_kernel(const Slots slots, const int* __restrict__ ptr,
                       const int2* __restrict__ ent, T* __restrict__ A,
                       T* __restrict__ b, int nb, int n, int flags)
{
    __shared__ SlotTable<T> tab;
    extern __shared__ unsigned char tile_raw[];
    T* tile = reinterpret_cast<T*>(tile_raw);
    tab.load(slots);
    __syncthreads();

    const int nn = n * n;
    const int per = nn + n;
    const int pitch = per | 1;
    const long long lane0 = (long long)blockIdx.x * TILE_LANES;
    const int nl = (int)min((long long)TILE_LANES, (long long)nb - lane0);
    const int l = threadIdx.x & 31;
    const bool accumulate = flags & FLAG_ACCUMULATE;
    const bool no_const = flags & FLAG_NO_CONST;
    if (l < nl) {
        const long long lane = lane0 + l;
        for (int t = threadIdx.x >> 5; t < per; t += WARPS) {
            T acc = T(0);
            if (accumulate)
                acc = t < nn ? A[lane * nn + t] : b[lane * n + (t - nn)];
            tile[l * pitch + t] = entry_sum(acc, tab, ptr, ent, t, lane,
                                            no_const);
        }
    }
    __syncthreads();
    T* const a0 = A + lane0 * nn;
    for (int i = threadIdx.x; i < nl * nn; i += THREADS) {
        const int ll = i / nn;
        a0[i] = tile[ll * pitch + (i - ll * nn)];
    }
    T* const b0 = b + lane0 * n;
    for (int i = threadIdx.x; i < nl * n; i += THREADS) {
        const int ll = i / n;
        b0[i] = tile[ll * pitch + nn + (i - ll * n)];
    }
}

// The entry form: one thread an entry, `lanes` whole systems a block.
template <typename T>
__global__ void __launch_bounds__(THREADS)
stamp_real_entry_kernel(const Slots slots, const int* __restrict__ ptr,
                        const int2* __restrict__ ent, T* __restrict__ A,
                        T* __restrict__ b, int nb, int n, int lanes,
                        int flags)
{
    __shared__ SlotTable<T> tab;
    tab.load(slots);
    __syncthreads();

    const long long lane0 = (long long)blockIdx.x * lanes;
    const int nl = (int)min((long long)lanes, (long long)nb - lane0);
    const int nn = n * n;
    const int na = nl * nn;
    const int total = na + nl * n;
    T* const a0 = A + lane0 * nn;
    T* const b0 = b + lane0 * n;
    const bool accumulate = flags & FLAG_ACCUMULATE;
    const bool no_const = flags & FLAG_NO_CONST;
    for (int i = threadIdx.x; i < total; i += THREADS) {
        int l, t;
        T* out;
        if (i < na) {
            l = i / nn;
            t = i - l * nn;
            out = a0 + i;
        } else {
            const int j = i - na;
            l = j / n;
            t = nn + (j - l * n);
            out = b0 + j;
        }
        *out = entry_sum(accumulate ? *out : T(0), tab, ptr, ent, t,
                         lane0 + l, no_const);
    }
}

// the tile form's shared memory at N (0: N too wide for it)
template <typename T>
size_t tile_bytes(int n)
{
    const size_t bytes = (size_t)TILE_LANES * ((n * n + n) | 1) * sizeof(T);
    return bytes <= (size_t)TILE_BYTES_MAX ? bytes : 0;
}

template <typename T>
int launch(const void* const* slot_ptr, const long long* lane_stride,
           const long long* elem_stride, int n_slots, const int* ptr,
           const int* ent, void* A, void* b, int nb, int n, int lanes,
           int flags, int form, void* stream)
{
    if (n_slots < 0 || n_slots > MAX_SLOTS || nb < 1 || n < 1 || lanes < 1
        || (form != FORM_TILE && form != FORM_ENTRY)
        || (form == FORM_TILE && tile_bytes<T>(n) == 0))
        return (int)cudaErrorInvalidValue;
    Slots slots;
    for (int s = 0; s < MAX_SLOTS; ++s) {
        const bool used = s < n_slots;
        slots.ptr[s] = used ? slot_ptr[s] : nullptr;
        slots.lane_stride[s] = used ? lane_stride[s] : 0;
        slots.elem_stride[s] = used ? elem_stride[s] : 0;
    }
    slots.count = n_slots;
    const int2* ent2 = reinterpret_cast<const int2*>(ent);
    T* a = static_cast<T*>(A);
    T* bb = static_cast<T*>(b);
    if (form == FORM_TILE) {
        const long long blocks = ((long long)nb + TILE_LANES - 1) / TILE_LANES;
        stamp_real_tile_kernel<T><<<(unsigned)blocks, THREADS,
                                    tile_bytes<T>(n),
                                    (cudaStream_t)stream>>>(
            slots, ptr, ent2, a, bb, nb, n, flags);
    } else {
        const long long blocks = ((long long)nb + lanes - 1) / lanes;
        stamp_real_entry_kernel<T><<<(unsigned)blocks, THREADS, 0,
                                     (cudaStream_t)stream>>>(
            slots, ptr, ent2, a, bb, nb, n, lanes, flags);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int stamp_real_f32(const void* const* slot_ptr, const long long* lane_stride,
                   const long long* elem_stride, int n_slots, const int* ptr,
                   const int* ent, void* A, void* b, int nb, int n,
                   int lanes, int flags, int form, void* stream)
{
    return launch<float>(slot_ptr, lane_stride, elem_stride, n_slots, ptr,
                         ent, A, b, nb, n, lanes, flags, form, stream);
}

int stamp_real_f64(const void* const* slot_ptr, const long long* lane_stride,
                   const long long* elem_stride, int n_slots, const int* ptr,
                   const int* ent, void* A, void* b, int nb, int n,
                   int lanes, int flags, int form, void* stream)
{
    return launch<double>(slot_ptr, lane_stride, elem_stride, n_slots, ptr,
                          ent, A, b, nb, n, lanes, flags, form, stream);
}

}  // extern "C"
