// The Poseidon permutation over Goldilocks (width 12, x^7, 30 full rounds)
// and the levels of the Merkle trees built from it: one thread a
// permutation, the 12-lane state in registers through all 30 rounds.
//
// Replaces no TPU kernel: the JAX package runs Poseidon as XLA elementwise
// ops (ethproof_tpu/hash/poseidon.py), and its plain PyTorch port
// (ethproof_tpu_torch/hash/poseidon.py, `permute_plain`) makes about 7,000
// int64 elementwise launches a permutation call, each a full pass over the
// (12, N) state. Here one launch does one call, or one whole level of a
// leaf digest or of a Merkle tree.
//
// The arithmetic is the plain version's, so every output is the same bits:
//   - round r adds the constants of row r (`goldilocks::add_mod`, whose
//     result is congruent to the sum for any u64 state, so lanes >= p give
//     what the plain `gf.field.add` gives), then x^7 as four modular
//     multiplies (x^2, x^3 = x^2 x, x^4 = x^2 x^2, x^7 = x^3 x^4: a 64x64 ->
//     128-bit product folded by `goldilocks::reduce128`, canonical), then
//     the MDS layer;
//   - the MDS matrix is circulant plus a diagonal (hash/constants.py):
//     out_i = sum_k kCirc[k] s[(i + k) % 12] + kDiag[i] s[i]. Its entries
//     are below 2^6 and a row sums below 2^9, so the sums over the 32-bit
//     limbs of the state are below 2^41 in a u64, and one fold per lane
//     gives h 2^32 + l mod p, canonical (gf/field.py, `reduce_wide`).
// The round constants live in __constant__ memory: every thread of a warp
// reads the same one at the same time, a broadcast.
//
// What bounds it on an H100: instruction issue, not memory. The round loop's
// body is 2,161 SASS instructions (sm_90a, CUDA 12.8), so a permutation is
// about 65,000, 41,000 of them for the integer ALU pipe (the IMADs issue to
// the FMA pipe), against 96 to 192 bytes of device-memory traffic: neither
// tensor cores nor TMA have a part. The grid gives one thread to each
// permutation, so a level of a wide leaf digest (705 x 16384 permutations
// at Keccak's first level) fills the card many times over.
// ptxas (sm_90a, CUDA 12.8): 64 registers (level) and 62 (permute), no
// spills. On an H100 80GB HBM3 at 700 W: 288-298 M permutations a second
// from 2^20 states up, 80.3 ms for Keccak's trace tree (23.1 M
// permutations), 70% of the ALU pipe's rate (bound 56.4 ms; PERF.md, Findings).
//
// Entry points (all launch on the given stream and return a cudaError_t):
//   - ethproof_poseidon_permute: out (12, n) contiguous = the permutation of
//     the (12, n) states read with the given strides;
//   - ethproof_poseidon_level: one level of a balanced two-to-one tree.
//     Group g of column n is the four elements src[j lane + g gstride +
//     n nstride], j < 4, zero where 4 g + j >= elems. Output column (i, n)
//     for i < pairs is the first four lanes of permute(group i, group
//     i + half, 0, 0, 0, 0); with `carry`, column (pairs, n) is group
//     pairs + half copied. out[j out_lane + i cols + n]. The first level of
//     a leaf digest reads the (L, N) rows directly (lane = row stride,
//     gstride = 4 rows, elems = L: the zero padding of the last group is
//     made in registers); the levels above it read (4, k, N) digests
//     (half = k / 2, carry = k odd); a Merkle level reads (4, M) digests,
//     siblings 2n and 2n + 1 (half = pairs = 1, nstride = 2 columns).

#include <cstdint>

#include <cuda_runtime.h>

#include "goldilocks.cuh"

namespace {

using namespace goldilocks;

constexpr int kWidth = 12;
constexpr int kRounds = 30;
constexpr int kThreads = 128;

// hash/constants.py: MDS_MATRIX_CIRC, MDS_MATRIX_DIAG (only entry 0 is not 0).
// The unrolled MDS loop reads kCirc at constant offsets, as operands of its
// multiply-adds.
__constant__ uint32_t kCirc[kWidth] = {17, 15, 41, 16, 2, 28, 13, 13, 39, 18, 34, 20};
constexpr uint32_t kDiag0 = 8;

// hash/constants.py: ALL_ROUND_CONSTANTS as (round, lane)
__constant__ uint64_t kRoundConstants[kRounds][kWidth] = {
    {0x9A46F376745EE568ull, 0xDE64876A3795A50Cull, 0x786EA76D456E3612ull, 0x9728CEA5AF3A294Full,
     0x44A7F2B449E53794ull, 0xA2CCF52BC8CB29BFull, 0x8B451AC2CDD699C6ull, 0x7A90E6FB7D820825ull,
     0x5445B8225060B2C7ull, 0x73BF7CC91A85D691ull, 0x42BA0FDEEAEC6F23ull, 0x9526DA14C3458103ull},
    {0x843454984C252FD3ull, 0xA280D8FCAE2F6140ull, 0x9E5AB1475E00BF8Bull, 0xAD4802F30A26333Full,
     0x249D792396C45FAEull, 0x750DE42A845AC5BFull, 0xA27E8A11B3377ADBull, 0x10881E87578966C2ull,
     0x4030C4FF8094970Eull, 0x8D3C752A73B6C244ull, 0x70A4B395DCACC5CCull, 0x6E0345B529625ADDull},
    {0xEC503EA2E76739C2ull, 0xA256F2D5B331B7ABull, 0xB6962967344D2ADAull, 0x2010B6D0A9CD72A7ull,
     0xE09F44FA9A7726DFull, 0x4E40DA42B40DAD01ull, 0xDF55E06D90858B10ull, 0x95D389B7AC59C485ull,
     0xC76577364596E412ull, 0x92112359EC33C65Bull, 0x8FF36F4883A660AFull, 0x8B85C6E11C31D6E8ull},
    {0xA4E42265ADA191FAull, 0x1C6E85558589C076ull, 0xA9D8D7D587F6350Aull, 0xF3A39457BECE1C0Cull,
     0xC19543B245E8D4AAull, 0x47CE25A484466608ull, 0x52E80D54038AD2A2ull, 0x8E7BE816F4DC3C3Aull,
     0x2DD35AE49DA51098ull, 0xC0272244E42686DBull, 0xF627060E3F66BF46ull, 0x3581EF36FB8785AAull},
    {0x91613F7EA1BF4B96ull, 0x42FDF650629C504Dull, 0x30F5D1AD679357F0ull, 0xDB5016A96C1DD31Full,
     0x76FDB0B538C54F45ull, 0x3CA9CB791CDAE30Full, 0x60331B1F282A2A61ull, 0x82546654D2AF0654ull,
     0xC81D9B0F7128ED7Cull, 0x7ACBF73A6D400727ull, 0x11BDAA7E67C90582ull, 0xFC0D27FA70099701ull},
    {0xEB593A35A94FA62Aull, 0xBB1182AA3231BB10ull, 0x3CE124D9383800BEull, 0x15033284B88B59E3ull,
     0x9FA6A586ED296415ull, 0x9EA085D274E4A230ull, 0x153B5F84DE2B37D4ull, 0x15D8CBDB98CE0BA4ull,
     0xD24BADDB72316817ull, 0xB87D3CC6C2D1C2FAull, 0x47349CF11E244348ull, 0x4E266CC5716FFC63ull},
    {0xE733872481F04133ull, 0x24317008965ECED8ull, 0x6FDBC6B5CDACF55Eull, 0x63859D7132DC3338ull,
     0x456E2964F61501DBull, 0x169ABDEC2281C284ull, 0xF28FEC8B43C881FCull, 0x65DF82CD2FE4284Eull,
     0xB4B32AF4E273E417ull, 0xEBCB6FC445E4ADDAull, 0x6AFB7EED1F3A0092ull, 0x68BDA81B95E72CA8ull},
    {0x36911A68D7311BD5ull, 0x36EF8C4CC1AE02D0ull, 0x8560DD12DA78F647ull, 0x2E50B1D4193A0621ull,
     0xF29DFAE72E759AA5ull, 0xB2401669160DE7B5ull, 0xB2889850C0E5D605ull, 0xC314FE89F855A3B7ull,
     0xAA12D9B08E8EFBE2ull, 0xDC96BCD93CB0DF65ull, 0x9960FB2D1DC4EB5Aull, 0x2281F491AA9D0E4Aull},
    {0x74BDC75865EFD8EEull, 0xEA5BCA19753BEBCCull, 0x92536A8D94BDF638ull, 0x06D07971442C7265ull,
     0x6FD1859CF7C8143Aull, 0x706809AB8D23C28Dull, 0x5BD42EBECBF32304ull, 0x96DF37E6769242D4ull,
     0xAAFBA844EDD13B57ull, 0x54030B8B6F83C7BAull, 0x155B7D778F39BBABull, 0x201549EC0D429878ull},
    {0xCB0E823D0DA7F2B1ull, 0x4A10A0C7A264CE2Eull, 0xEE6EEACFD750E28Full, 0xBF55F6B61AEE6268ull,
     0xEB6BF3667DC05244ull, 0x4A1B87F38BA90532ull, 0xE887E66AD7E8672Eull, 0x19B86DEDBB0B4642ull,
     0x9A5E653621E34F66ull, 0x73D56C54B5006548ull, 0xF4F1A50351409E59ull, 0xA9CF9F731657E0BBull},
    {0xD12B132DC597C7BAull, 0xD7FB0D242F749038ull, 0x9A06B57DD30BDDE3ull, 0xEFE24B332C39CCD1ull,
     0xF716E65367CB6305ull, 0x4AF6AD8380F7C958ull, 0xFFE456261061F23Full, 0x3155EC4B2E5148B5ull,
     0xF89199CCD100A732ull, 0x72C48947B8B673C5ull, 0xC95F177A35545795ull, 0xB85079DFD6AA4FFAull},
    {0x6789BA832324D2AAull, 0x9877C07D02420EC5ull, 0x4C16490F0ADBBCF2ull, 0x77B7863D56331606ull,
     0xC0415D0149867D33ull, 0xE2170EFEE3F71BAEull, 0xE002CFFF7F343DF7ull, 0x35939271A3BA55AEull,
     0xCCAFD98C3F5E0430ull, 0x503003DE97304F8Cull, 0x3298C26F082DDD57ull, 0x29C3E7A8AE539191ull},
    {0xAD576D458F684A19ull, 0xB1BF5C32EA08BC3Full, 0x226DD6C26E009DB9ull, 0xF08ECE730511C97Eull,
     0x55F10E262BAFA2F1ull, 0x075C74BDB0C63DAAull, 0xC21CABC3CB45C761ull, 0xE3DB15720241F021ull,
     0xE57090F87D5FA001ull, 0x42F58AA6005B95D2ull, 0x31414592652BFBC2ull, 0xF8BA68FCC4FCFD2Full},
    {0xBD6A343CD7A27067ull, 0xCE3E17951F2E2755ull, 0x1E04DECA8A6CFC6Full, 0xEAF081EAC8F4A0CAull,
     0x740002C51AEBB9D2ull, 0xCECE12C2C0D4DFC4ull, 0xB747E29684755C15ull, 0x94B6EA4BB82D1A70ull,
     0x7618A383EEE47290ull, 0x99D266A35290CA7Aull, 0x60C3459F64768CC3ull, 0x4B769A8C7F46C5EEull},
    {0x0CA0DB5F20AB110Eull, 0x59B750CF9104ADF0ull, 0x23FA145915CCB236ull, 0x25CB5729A623B96Cull,
     0xFAFB146B52A50DDAull, 0xB57184E1738BD6F9ull, 0x5394D6D3EE2262B7ull, 0x317B89556B8974AFull,
     0x25F96D57EA696D94ull, 0xDE7CCAA5BB5C350Full, 0x92F51C16F36B745Eull, 0x27A041CC2FF8EAE2ull},
    {0x85AB69496BDA13CEull, 0x2E0BE1D6BDE1A106ull, 0x3B8A34A3FA83E642ull, 0x8367DE10705E3B83ull,
     0xF81EFE3FE3AC4A6Dull, 0x831832E0983D8AB1ull, 0x50E72D38B77117BDull, 0xA0BB0D4B9C569041ull,
     0x4711710DB3FE5FC9ull, 0xE53B924D32FB3D05ull, 0xE94E40596F0D61D1ull, 0x5477FA566D4066A3ull},
    {0xF545B0380FD2B8BEull, 0xE9C3ABF766015E65ull, 0x4D10243825302D79ull, 0xBE4F0452B2DF7AB5ull,
     0x5645020287DBB474ull, 0x33757F2B191A5C29ull, 0x0F89A767D84FF414ull, 0xA4FC118B81323436ull,
     0x91E0419F014CA573ull, 0x9440D43E918A4CA4ull, 0xB7FE03AC752C64F8ull, 0xF2239BE098D7633Cull},
    {0xF3D398A43F1995ADull, 0xB524F32278A670B7ull, 0xCE9C199D4B5F78A2ull, 0x420179A8B6C62925ull,
     0x48FA68C25E868848ull, 0xD2A0D097E046E0D4ull, 0x2D2A9F6BC9E1C811ull, 0x9826B8D49BEA8AD3ull,
     0x613ADEAC8AB119D6ull, 0x669EE04889BC1E10ull, 0xDF82365B78F84956ull, 0xA5CEE33C48835C74ull},
    {0x40F881F28616E5B3ull, 0xEF13C0509523A7CEull, 0x893B706879E2678Full, 0x137D01441B3BE7EBull,
     0x4AA8E0E7E6B55ACBull, 0xA4F44066E83FA527ull, 0x8885D6BD57439A01ull, 0xF9BF6681A60DC6B7ull,
     0xBECF5D2F88A9973Eull, 0x9BC52563E0EF8444ull, 0xE275945BB242FA40ull, 0x19F7F5BD6C6482AAull},
    {0x37FFA9979E6D5A41ull, 0xE293640C783F5C76ull, 0xF4038910BF507A46ull, 0x87CB1FC945E70FCFull,
     0x5433034FB59A6BBBull, 0xB4CBB983993CD8EFull, 0x66A4C7C32CB2FD72ull, 0xBE06E26E223536EDull,
     0xEC380F2AEB33EEEAull, 0x33528FA0F0CBCFA6ull, 0x8B806E7E2DF5C303ull, 0x4B428D26A3095107ull},
    {0x5327E7A3D7922EF0ull, 0xEC0951335EFA3D0Full, 0x80CE8F31DC1631C5ull, 0x6332C4B0497D8683ull,
     0xDFCAB8528D406A71ull, 0x942754B4AC89A773ull, 0xAD3AC40DD726B4D2ull, 0xCCEB79E29EEA82F0ull,
     0xA2DF608FBC79A53Aull, 0x26646F3BA0FDBE93ull, 0xBBAC1C97D22635E5ull, 0x526F69990211F840ull},
    {0x5C8F43B173E0D19Aull, 0x07C77D9B9F8C6490ull, 0x55F997008B69C71Aull, 0xFC2824EEA8A1EB8Dull,
     0x3216AC3B5C76C385ull, 0x2CE3BB1A72E3BD4Eull, 0x952B85CB53ED6BD0ull, 0x0B7E89B42640B1BAull,
     0x840821D3EBE0737Dull, 0x4674545C7BA4A4D3ull, 0x4389DEF638E059A0ull, 0x1427A41B920E792Aull},
    {0xED9652D953B2B2BAull, 0x31A7D81BD3E2F644ull, 0x08918390E1436F45ull, 0xF05A6D527301DE3Dull,
     0x3E444402D89793B4ull, 0x59B1EEA352C237DBull, 0x60FFDE8B26391364ull, 0xAD1E649CEE8837BAull,
     0xC056F5347EF35B02ull, 0xC2FDD46F5BB8EA8Dull, 0xA353B4F0377A3D42ull, 0x39061D2DFF2A6310ull},
    {0x3813E690FF0F1895ull, 0x823A70B7115BF5F7ull, 0xC56E05886ADA67DAull, 0x5CE4FF14F48DA74Full,
     0xA46F871CB5983386ull, 0x9CA93EA3DE5B7262ull, 0xB1FEA21758A7944Dull, 0x0EF6E220C77A45F7ull,
     0x5732A5DF49EAF631ull, 0x9F6EFB9828EA02AAull, 0x469919E787DC0125ull, 0x4051CABB38BF84A4ull},
    {0xFD8CD0C75D93DB06ull, 0x8370C46E3A9826CBull, 0x5F441E16A4B5F0CBull, 0x1818482E32F8DED6ull,
     0x17730C6EDC44A38Eull, 0xA871D4A79D958A17ull, 0x17030D651727D1C6ull, 0x587E6E9713310D41ull,
     0x4B1421234FE9C492ull, 0x3445A673E71F4E7Full, 0x96A2B7D59D51AC97ull, 0xD77C5DF65E05863Cull},
    {0x8BA55D13B2224D25ull, 0xA1FFA49380DF56DBull, 0x25B030E8EC7490D4ull, 0x4C2C5A155DC51F80ull,
     0x0B26FE0440B92CE0ull, 0x759658451B27FA42ull, 0x21C0DA77F1C6D75Dull, 0xE4AEA84CFCF0B25Dull,
     0x1C996EEFBCAEA649ull, 0xDCDA0562C5F9BF59ull, 0xCE9226ADF3952218ull, 0x3B26A104E2CD851Dull},
    {0xA1F2F8FDBDA097B3ull, 0xC72AE927EFDC4975ull, 0x7AAB549F1A761A02ull, 0x0533DBCCCD61066Bull,
     0xA5B0BE4F0F7494A8ull, 0x754976F83F03F15Dull, 0x5AED420E71B08B52ull, 0x66708D341828A9DFull,
     0x3BFA10FCB4E8F3D4ull, 0xBF35FAEECD0DDBABull, 0x5D71A081EBCFCFE2ull, 0x4AA9A9BB5BB31D5Dull},
    {0x94146AEA046CEBCDull, 0x1E8D69A6146314BFull, 0xF9B3EE164F34C9ACull, 0xA73D331DE16F9F31ull,
     0xBAB37A2C641909DDull, 0x3ADAF1C18D17628Eull, 0x6AF77650F4E0F321ull, 0x0939C318238D0F81ull,
     0x575A27AEE3B4A215ull, 0x36AA7E53FBF7C2C6ull, 0x91DDACB57C57E0B6ull, 0x324E70107394204Bull},
    {0x1955E09F94A93CEFull, 0x656EADEF2E5673D8ull, 0x0D4FC15F6211E2B2ull, 0x2C5D39F3EEF69DBDull,
     0x0DF0B370E51F513Cull, 0x82B74E5ACAD4509Dull, 0xFFC7739E8D77E9FBull, 0x0639A9BBA26656CDull,
     0xD2A145C98EE96065ull, 0x909842C8D6297084ull, 0x468B89BDC8F905F6ull, 0x18D8554AD9F9C0A9ull},
    {0xAEE685AC5A9153A1ull, 0x6E89D07BAB5F4844ull, 0xAFBE3A4ED1DC24B4ull, 0x84AD83F73BBA067Full,
     0x1546575023E29169ull, 0xA28926365BAB32E7ull, 0xD9BD1EF4921C290Aull, 0x68049A18767A450Dull,
     0x0CACAC82277B499Aull, 0xAE3DF2D3B283F6D6ull, 0xE023584B8DA688EBull, 0x72FC20B084C482F2ull}
};

__device__ __forceinline__ uint64_t mul_mod(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  const uint64_t x2 = mul_mod(x, x);
  const uint64_t x3 = mul_mod(x2, x);
  const uint64_t x4 = mul_mod(x2, x2);
  return mul_mod(x3, x4);
}

// h 2^32 + l mod p, canonical, for h, l < 2^62 (gf/field.py, reduce_wide)
__device__ __forceinline__ uint64_t fold_wide(uint64_t h, uint64_t l) {
  h += l >> 32;
  const uint64_t w = (h << 32) | (l & kEps);
  const uint64_t t = (h >> 32) * kEps;
  const uint64_t r = w + t;
  return (r < t || r >= kP) ? r + kEps : r;
}

__device__ __forceinline__ void mds(uint64_t (&s)[kWidth]) {
  uint32_t lo[kWidth], hi[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) {
    lo[j] = (uint32_t)s[j];
    hi[j] = (uint32_t)(s[j] >> 32);
  }
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    uint64_t sl = 0, sh = 0;
#pragma unroll
    for (int k = 0; k < kWidth; ++k) {
      sl += (uint64_t)kCirc[k] * lo[(i + k) % kWidth];
      sh += (uint64_t)kCirc[k] * hi[(i + k) % kWidth];
    }
    if (i == 0) {
      sl += (uint64_t)kDiag0 * lo[0];
      sh += (uint64_t)kDiag0 * hi[0];
    }
    s[i] = fold_wide(sh, sl);
  }
}

__device__ __forceinline__ void permute_state(uint64_t (&s)[kWidth]) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
#pragma unroll
    for (int j = 0; j < kWidth; ++j) s[j] = sbox(add_mod(s[j], kRoundConstants[r][j]));
    mds(s);
  }
}

__global__ void __launch_bounds__(kThreads)
permute_kernel(const uint64_t* __restrict__ src, long long lane, long long nstride,
               uint64_t* __restrict__ out, long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  uint64_t s[kWidth];
#pragma unroll
  for (int j = 0; j < kWidth; ++j) s[j] = src[j * lane + t * nstride];
  permute_state(s);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) out[j * n + t] = s[j];
}

__global__ void __launch_bounds__(kThreads)
level_kernel(const uint64_t* __restrict__ src, long long lane, long long gstride,
             long long nstride, long long elems, long long half, long long pairs,
             long long cols, long long total, uint64_t* __restrict__ out, long long out_lane) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long i = t / cols;
  const long long n = t - i * cols;
  const uint64_t* col = src + n * nstride;
  uint64_t* dst = out + i * cols + n;
  if (i >= pairs) {  // the odd carry: group pairs + half, copied
    const long long g = i + half;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dst[j * out_lane] = 4 * g + j < elems ? col[j * lane + g * gstride] : 0;
    return;
  }
  uint64_t s[kWidth];
  const long long gl = i, gr = i + half;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = 4 * gl + j < elems ? col[j * lane + gl * gstride] : 0;
    s[4 + j] = 4 * gr + j < elems ? col[j * lane + gr * gstride] : 0;
    s[8 + j] = 0;
  }
  permute_state(s);
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[j * out_lane] = s[j];
}

unsigned grid(long long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int ethproof_poseidon_permute(const void* src, long long lane, long long nstride,
                                         void* out, long long n, void* stream) {
  if (n < 0 || lane < 0 || nstride < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  permute_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)src, lane, nstride, (uint64_t*)out, n);
  return (int)cudaGetLastError();
}

extern "C" int ethproof_poseidon_level(const void* src, long long lane, long long gstride,
                                       long long nstride, long long elems, long long half,
                                       long long pairs, int carry, long long cols, void* out,
                                       long long out_lane, void* stream) {
  if (cols < 0 || pairs < 0 || half < pairs || lane < 0 || gstride < 0 || nstride < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (pairs + (carry ? 1 : 0)) * cols;
  if (total == 0) return (int)cudaSuccess;
  level_kernel<<<grid(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)src, lane, gstride, nstride, elems, half, pairs, cols, total,
      (uint64_t*)out, out_lane);
  return (int)cudaGetLastError();
}
