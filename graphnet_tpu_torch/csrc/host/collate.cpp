// Host-side padding of ragged events into the dense [B, L, D] layout.
//
// The DataLoader's padding loop (one numpy slice assignment per event)
// as one C call per batch: memcpy each event's rows into a zeroed
// buffer and set its mask.  Built with g++ at first use
// (graphnet_tpu_torch/native.py) and called through ctypes, which
// releases the GIL for the call.

#include <algorithm>
#include <cstdint>
#include <cstring>

extern "C" {

// Pad a batch of events into preallocated output buffers.
//   events:    B pointers, events[i] -> float32 [lengths[i], dim]
//   lengths:   [B] rows per event
//   n_events:  B
//   dim:       feature count D
//   max_len:   padded length L (longer events are truncated)
//   out_x:     [B * L * dim] float32, zero-filled here
//   out_mask:  [B * L] uint8, zero-filled here
//   out_n:     [B] int32 clipped lengths
void pad_events(const float** events,
                const int32_t* lengths,
                int32_t n_events,
                int32_t dim,
                int32_t max_len,
                float* out_x,
                uint8_t* out_mask,
                int32_t* out_n) {
    const int64_t row = static_cast<int64_t>(dim);
    const int64_t ev_stride = static_cast<int64_t>(max_len) * row;
    std::memset(out_x, 0, sizeof(float) * ev_stride * n_events);
    std::memset(out_mask, 0,
                sizeof(uint8_t) * static_cast<int64_t>(max_len) * n_events);
    for (int32_t i = 0; i < n_events; ++i) {
        const int32_t n = std::min(lengths[i], max_len);
        out_n[i] = n;
        std::memcpy(out_x + i * ev_stride, events[i],
                    sizeof(float) * static_cast<int64_t>(n) * row);
        std::memset(out_mask + static_cast<int64_t>(i) * max_len, 1, n);
    }
}

// Pad per-node label vectors (one float per node) into [B, L].
void pad_node_labels(const float** labels,
                     const int32_t* lengths,
                     int32_t n_events,
                     int32_t max_len,
                     float* out) {
    std::memset(out, 0,
                sizeof(float) * static_cast<int64_t>(max_len) * n_events);
    for (int32_t i = 0; i < n_events; ++i) {
        const int32_t n = std::min(lengths[i], max_len);
        std::memcpy(out + static_cast<int64_t>(i) * max_len, labels[i],
                    sizeof(float) * n);
    }
}

}  // extern "C"
